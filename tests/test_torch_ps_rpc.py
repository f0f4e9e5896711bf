"""The PS transport of the port (paddle_tpu_torch/distributed/ps/rpc.py)
against paddle_tpu/distributed/ps/rpc.py, and its chaos proofs.

Parity, exact (bitwise table state, byte-equal frames): the port's
client against the JAX package's server and the JAX package's client
against the port's server run the same scripted pulls and pushes as a
JAX-only pair and end with the same tables and ``applied`` counters; a
torch tensor handed to the port's client (on any device) goes on the
wire as numpy; the two packages pack a request into the same bytes.

The chaos proofs are tests/test_ps_faults.py's and
tests/test_obs_ps_trace.py's, on the port. Every fault is INJECTED —
seeded and scripted through paddle_tpu_torch.testing.faults, no real
network partitions — and every server binds port 0 itself (the chaos
run's restart takes the port its predecessor was given). The contract
under test mirrors the reference's brpc channel guarantees
(connect_timeout + retry policy + idempotent service handlers):

- transient resets / lost replies / stalls are retried under a deadline,
  and mutating calls apply EXACTLY ONCE via the server replay cache;
- a stall past PADDLE_PS_CALL_TIMEOUT raises DeadlineExceeded naming the
  method and endpoint once the retry budget is spent;
- oversized / garbled frames are rejected cleanly on both ends;
- a full 2-server training run threaded with faults plus a mid-run
  server kill + snapshot restore ends bitwise-equal to a fault-free run;
- the ps.rpc.* monitor counters tick so supervisors can see flakiness.
"""
import socket
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import monitor, trace
from paddle_tpu_torch.distributed.ps import PSClient, PSServer
from paddle_tpu_torch.distributed.ps import rpc
from paddle_tpu_torch.testing import faults

pytestmark = pytest.mark.chaos

DIM = 4

# tight-but-safe chaos timings: per-attempt deadline far above an
# in-process RPC (~1ms) yet small enough that deadline tests stay fast
FAST = dict(timeout=5.0, max_retries=3, backoff_base=0.01,
            backoff_max=0.05, connect_retry_s=5.0)


def _sparse_spec(optimizer="sgd", lr=1.0):
    return {"type": "sparse", "dim": DIM, "optimizer": optimizer,
            "lr": lr, "init": "zeros"}


def _dense_spec():
    return {"type": "dense", "shape": (3, DIM), "optimizer": "sgd",
            "lr": 0.1, "init": "zeros"}


@pytest.fixture()
def server():
    srv = PSServer(tables={"emb": _sparse_spec(),
                           "dense0": _dense_spec()})
    srv.start()
    yield srv
    srv.shutdown()


@pytest.fixture(autouse=True)
def _no_leftover_injector():
    trace.reset()
    yield
    faults.uninstall()
    trace.reset()


def _delta(before, name):
    return monitor.stat_get(name) - before.get(name, 0)


# ---------------------------------------------------------------- retry

def test_retry_survives_connection_reset(server):
    client = PSClient([server.endpoint], **FAST)
    before = monitor.stats("ps.rpc.")
    with faults.inject(faults.Fault("client", "send", faults.RESET,
                                    method="pull_sparse", times=2)) as inj:
        rows = client.pull_sparse("emb", [1, 2, 3])
    assert rows.shape == (3, DIM)
    assert inj.fired(faults.RESET) == 2
    assert _delta(before, "ps.rpc.retries") >= 2
    assert _delta(before, "ps.rpc.reconnects") >= 2
    # counters are part of the public stats() surface
    assert "ps.rpc.retries" in monitor.stats()
    client.close()


def test_reconnect_reruns_auth_handshake(server, monkeypatch):
    # token read at serve() time is already set? serve() captured env at
    # start — spin a dedicated server AFTER setting the token
    monkeypatch.setenv("PADDLE_PS_TOKEN", "sekrit-chaos")
    srv = PSServer(tables={"emb": _sparse_spec()})
    srv.start()
    try:
        client = PSClient([srv.endpoint], **FAST)
        with faults.inject(faults.Fault("client", "recv", faults.RESET,
                                        method="pull_sparse")) as inj:
            rows = client.pull_sparse("emb", [7])
        assert rows.shape == (1, DIM)
        assert inj.fired() == 1  # the re-dial re-ran __auth__ and served
        client.close()
    finally:
        srv.shutdown()


# ------------------------------------------------------- exactly-once

def test_dropped_reply_applies_push_exactly_once(server):
    """THE keystone: the reply to push_sparse_grad is lost after the
    server applied it; the client's retry must hit the replay cache, not
    the optimizer."""
    client = PSClient([server.endpoint], **FAST)
    client.pull_sparse("emb", [1, 2, 3])          # materialize rows at 0
    table = server.table("emb")
    applied0 = table.applied
    before = monitor.stats("ps.rpc.")
    with faults.inject(faults.Fault("server", "reply", faults.DROP,
                                    method="push_sparse_grad")) as inj:
        client.push_sparse_grad("emb", [1, 2, 3],
                                np.ones((3, DIM), np.float32))
    assert inj.fired(faults.DROP) == 1
    # applied once, replayed (not re-applied) on the retry
    assert table.applied == applied0 + 1
    assert client.table_applied("emb") == applied0 + 1
    assert _delta(before, "ps.rpc.replays") >= 1
    # sgd lr=1.0 from zeros: exactly one application == exactly -1.0
    np.testing.assert_array_equal(
        client.pull_sparse("emb", [1, 2, 3]),
        -np.ones((3, DIM), np.float32))
    client.close()


def test_dropped_reply_dense_and_barrier_replay(server):
    client = PSClient([server.endpoint], **FAST)
    srv_table = server.table("dense0")
    with faults.inject(
            faults.Fault("server", "reply", faults.DROP,
                         method="push_dense_grad"),
            faults.Fault("server", "reply", faults.DROP,
                         method="set_dense")) as inj:
        client.set_dense("dense0", np.full((3, DIM), 5.0, np.float32))
        client.push_dense_grad("dense0", np.ones((3, DIM), np.float32))
    assert inj.fired(faults.DROP) == 2
    # one set + one sgd step (lr=0.1): 5.0 - 0.1, not 5.0 - 0.2
    np.testing.assert_allclose(client.pull_dense("dense0"),
                               np.full((3, DIM), 4.9, np.float32))
    assert srv_table.applied == 2
    client.close()


# --------------------------------------------------------- deadlines

def test_stall_past_deadline_names_method_and_endpoint(server):
    client = PSClient([server.endpoint], timeout=0.3, max_retries=1,
                      backoff_base=0.01, backoff_max=0.02,
                      connect_retry_s=2.0)
    before = monitor.stats("ps.rpc.")
    with faults.inject(faults.Fault("server", "reply", faults.STALL,
                                    method="pull_dense", times=10,
                                    delay=1.0)):
        with pytest.raises(rpc.DeadlineExceeded) as ei:
            client.pull_dense("dense0")
    msg = str(ei.value)
    assert "pull_dense" in msg and server.endpoint in msg
    assert _delta(before, "ps.rpc.deadline_exceeded") >= 1
    assert _delta(before, "ps.rpc.retries") >= 1
    client.close()


def test_stalled_mutation_is_rescued_by_replay(server):
    """A stall on the REPLY of a mutating call: the first attempt times
    out client-side after the server applied+committed, and the retry
    replays the cached reply — the call SUCCEEDS and applies once."""
    client = PSClient([server.endpoint], timeout=0.4, max_retries=2,
                      backoff_base=0.01, backoff_max=0.02,
                      connect_retry_s=2.0)
    client.pull_sparse("emb", [9])
    table = server.table("emb")
    applied0 = table.applied
    with faults.inject(faults.Fault("server", "reply", faults.STALL,
                                    method="push_sparse_grad", times=1,
                                    delay=1.0)):
        client.push_sparse_grad("emb", [9], np.ones((1, DIM), np.float32))
    assert table.applied == applied0 + 1
    np.testing.assert_array_equal(client.pull_sparse("emb", [9]),
                                  -np.ones((1, DIM), np.float32))
    client.close()


# ------------------------------------------------------------- frames

def test_oversized_frame_rejected_without_allocation():
    a, b = socket.socketpair()
    try:
        b.sendall(rpc._HDR.pack(1 << 45))   # 32 TiB claim
        with pytest.raises(rpc.FrameError, match="PADDLE_PS_MAX_FRAME"):
            rpc.recv_msg(a)
    finally:
        a.close()
        b.close()


def test_oversized_send_refused():
    a, b = socket.socketpair()
    try:
        with pytest.raises(rpc.FrameError, match="refusing to send"):
            rpc.send_msg(a, {"x": np.zeros(1 << 12, np.uint8)},
                         max_frame=1 << 10)
    finally:
        a.close()
        b.close()


def test_garbled_frame_rejected_cleanly():
    a, b = socket.socketpair()
    try:
        b.sendall(rpc._HDR.pack(10) + b"\x00" * 10)
        with pytest.raises((rpc.FrameError, Exception)) as ei:
            rpc.recv_msg(a)
        # specifically a clean frame/pickle rejection, not an OOM/crash
        import pickle
        assert isinstance(ei.value, (rpc.FrameError,
                                     pickle.UnpicklingError))
    finally:
        a.close()
        b.close()


def test_server_survives_bad_frames_from_one_peer(server):
    """A hostile/garbled connection is dropped per-connection; the server
    keeps serving everyone else and counts the event."""
    before = monitor.stats("ps.rpc.")
    host, port = server.endpoint.rsplit(":", 1)
    evil = socket.create_connection((host, int(port)), timeout=5.0)
    evil.sendall(rpc._HDR.pack(1 << 45))
    evil.settimeout(5.0)
    # server answers with a best-effort error frame and/or closes; either
    # way the stream ends rather than allocating 32 TiB
    try:
        data = evil.recv(1 << 16)
        if data:
            assert b"bad frame" in data
    except OSError:
        pass
    evil.close()
    assert _delta(before, "ps.rpc.bad_frames") >= 1
    # a well-behaved client is unaffected
    client = PSClient([server.endpoint], **FAST)
    assert client.pull_sparse("emb", [4]).shape == (1, DIM)
    assert client.ping()[0] < 5.0
    client.close()


def test_garbled_reply_triggers_retry(server):
    client = PSClient([server.endpoint], **FAST)
    with faults.inject(faults.Fault("server", "reply", faults.GARBLE,
                                    method="pull_sparse")) as inj:
        rows = client.pull_sparse("emb", [11])
    assert inj.fired(faults.GARBLE) == 1
    assert rows.shape == (1, DIM)
    client.close()


def test_ping_served_before_auth(monkeypatch):
    monkeypatch.setenv("PADDLE_PS_TOKEN", "sekrit-ping")
    stop = threading.Event()
    port, _ = rpc.serve("127.0.0.1:0", lambda m, kw: None, stop)
    try:
        # a tokenless probe: no __auth__ frame, just __ping__
        monkeypatch.delenv("PADDLE_PS_TOKEN")
        sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        rpc.send_msg(sock, {"method": "__ping__"})
        assert rpc.recv_msg(sock) == {"result": "pong"}
        # ...but real methods still require the handshake
        rpc.send_msg(sock, {"method": "pull_dense", "table": "x"})
        reply = rpc.recv_msg(sock)
        assert reply and "auth required" in reply.get("error", "")
        sock.close()
    finally:
        stop.set()


# ------------------------------------------------- chaos training run

N_STEPS = 24
SNAP_STEP = 11          # snapshot lands after this step's pushes
KILL_STEP = 17          # server 0 dies after this step completes
VOCAB = 64


def _train_steps(client, start, stop_, snap_path=None):
    """Deterministic 2-table loop; grads depend on PULLED state, so any
    lost or double-applied update poisons every later step."""
    for step in range(start, stop_):
        rng = np.random.RandomState(1000 + step)
        ids = rng.randint(0, VOCAB, size=10).astype(np.int64)
        rows = client.pull_sparse("emb", ids)
        grads = rows * 0.05 + rng.randn(len(ids), DIM).astype(np.float32)
        client.push_sparse_grad("emb", ids, grads)
        dense = client.pull_dense("dense0")
        client.push_dense_grad(
            "dense0", dense * 0.05 + rng.randn(3, DIM).astype(np.float32))
        if step == SNAP_STEP and snap_path:
            client.save_snapshot(snap_path)


def _final_state(client):
    all_ids = np.arange(VOCAB, dtype=np.int64)
    return (client.pull_sparse("emb", all_ids).copy(),
            client.pull_dense("dense0").copy())


def _spawn_servers(ports):
    servers = []
    for p in ports:
        srv = PSServer(endpoint=f"127.0.0.1:{p}",
                       tables={"emb": _sparse_spec("adagrad", lr=0.1),
                               "dense0": _dense_spec()})
        srv.start()
        servers.append(srv)
    return servers


def test_chaos_training_bitwise_equals_fault_free(tmp_path):
    """2-server PS training with seeded resets + dropped replies AND a
    mid-run server kill + snapshot-restore: the final dense and sparse
    tables must be BITWISE equal to a fault-free run — no lost, no
    double-applied gradients."""
    # ---- fault-free reference run
    ref_servers = _spawn_servers((0, 0))
    ref_client = PSClient([s.endpoint for s in ref_servers], **FAST)
    _train_steps(ref_client, 0, N_STEPS,
                 snap_path=str(tmp_path / "ref_snap"))
    ref_sparse, ref_dense = _final_state(ref_client)
    ref_client.close()
    for s in ref_servers:
        s.shutdown()

    # ---- chaos run: seeded resets + lost replies through every step
    servers = _spawn_servers((0, 0))
    endpoints = [s.endpoint for s in servers]
    client = PSClient(endpoints, **FAST)
    before = monitor.stats("ps.rpc.")
    snap = str(tmp_path / "chaos_snap")
    with faults.inject(seed=7, p={faults.RESET: 0.04,
                                  faults.DROP: 0.04}) as inj:
        _train_steps(client, 0, KILL_STEP + 1, snap_path=snap)

        # ---- mid-run crash of server 0, restart on the SAME endpoint
        servers[0].shutdown()
        fresh = _spawn_servers((int(endpoints[0].rsplit(":", 1)[1]),))[0]
        servers[0] = fresh
        # global rollback to the snapshot, replay the suffix — the
        # standard PS recovery the reference's HeartBeatMonitor +
        # large_scale_kv checkpointing enable
        client.load_snapshot(snap)
        _train_steps(client, SNAP_STEP + 1, N_STEPS)

    got_sparse, got_dense = _final_state(client)
    # the chaos actually happened...
    assert inj.fired(faults.DROP) >= 1, "seed injected no drops"
    assert inj.fired(faults.RESET) >= 1, "seed injected no resets"
    # ...the transport reported it through the monitor...
    assert _delta(before, "ps.rpc.retries") >= 1
    assert _delta(before, "ps.rpc.reconnects") >= 1
    assert _delta(before, "ps.rpc.replays") >= 1
    # ...and not one gradient was lost or double-counted
    np.testing.assert_array_equal(got_sparse, ref_sparse)
    np.testing.assert_array_equal(got_dense, ref_dense)
    client.close()
    for s in servers:
        s.shutdown()


def test_chaos_run_is_seed_deterministic():
    """Same seed -> same injected fault sequence per stream (the
    scripted-chaos determinism the harness promises downstream tests)."""
    a = faults.FaultInjector(seed=42, p={faults.DROP: 0.5})
    b = faults.FaultInjector(seed=42, p={faults.DROP: 0.5})
    seq_a = [a.on_event("server", "reply", "push_sparse_grad")
             for _ in range(64)]
    seq_b = [b.on_event("server", "reply", "push_sparse_grad")
             for _ in range(64)]
    assert seq_a == seq_b
    assert seq_a.count("drop") > 0
    c = faults.FaultInjector(seed=43, p={faults.DROP: 0.5})
    seq_c = [c.on_event("server", "reply", "push_sparse_grad")
             for _ in range(64)]
    assert seq_a != seq_c


def test_two_communicators_share_client_without_replay_collision(server):
    """Replay keys are namespaced per Communicator: a second instance
    over the SAME PSClient restarts its batch numbering, and its pushes
    must apply — not be mistaken for replays of the first one's."""
    from paddle_tpu_torch.distributed.ps import Communicator
    client = PSClient([server.endpoint], **FAST)
    client.pull_sparse("emb", [5])
    table = server.table("emb")
    applied0 = table.applied
    for _ in range(2):
        comm = Communicator(client, send_every=1, max_queue=8,
                            max_delay_s=0.01)
        comm.push_sparse("emb", [5], np.ones((1, DIM), np.float32))
        comm.flush(timeout=30.0)
        comm.stop()
    assert table.applied == applied0 + 2
    np.testing.assert_array_equal(client.pull_sparse("emb", [5]),
                                  -2.0 * np.ones((1, DIM), np.float32))
    client.close()


def test_oversized_request_fails_fast_without_retry(server):
    """A request over the frame bound is a deterministic LOCAL error:
    FrameError immediately, no retries, no reconnect churn."""
    client = PSClient([server.endpoint], **FAST)
    client.pull_sparse("emb", [1])          # connection warm and healthy
    before = monitor.stats("ps.rpc.")
    from paddle_tpu_torch.core.flags import set_flags
    set_flags({"PADDLE_PS_MAX_FRAME": 4096})
    try:
        with pytest.raises(rpc.FrameError, match="PADDLE_PS_MAX_FRAME"):
            client.push_sparse_grad(
                "emb", np.arange(4096, dtype=np.int64),
                np.ones((4096, DIM), np.float32))
    finally:
        set_flags({"PADDLE_PS_MAX_FRAME": 1 << 30})
    assert _delta(before, "ps.rpc.retries") == 0
    assert _delta(before, "ps.rpc.reconnects") == 0
    # the connection is still usable afterwards
    assert client.pull_sparse("emb", [1]).shape == (1, DIM)
    client.close()


def test_communicator_retries_through_faults(server):
    """The async send thread rides the retrying transport: a reset +
    dropped reply under its merged batch neither kills the thread nor
    double-applies."""
    from paddle_tpu_torch.distributed.ps import Communicator
    client = PSClient([server.endpoint], **FAST)
    client.pull_sparse("emb", [1, 2])
    table = server.table("emb")
    applied0 = table.applied
    comm = Communicator(client, send_every=2, max_queue=16,
                        max_delay_s=0.01)
    with faults.inject(
            faults.Fault("client", "send", faults.RESET,
                         method="push_sparse_grad"),
            faults.Fault("server", "reply", faults.DROP,
                         method="push_sparse_grad")):
        comm.push_sparse("emb", [1], np.ones((1, DIM), np.float32))
        comm.push_sparse("emb", [2], np.ones((1, DIM), np.float32))
        comm.flush(timeout=30.0)
    comm.stop()
    # one merged batch, applied exactly once despite both faults
    assert table.applied == applied0 + 1
    np.testing.assert_array_equal(client.pull_sparse("emb", [1, 2]),
                                  -np.ones((2, DIM), np.float32))
    client.close()


# -------------------------------- trace context across the transport

def _spans(name):
    return [s for s in trace.recent() if s.name == name]


def test_server_span_parents_to_client_call(server):
    client = PSClient([server.endpoint], **FAST)
    client.pull_sparse("emb", [1, 2, 3])
    client.close()
    csp = _spans("ps.rpc/pull_sparse")[-1]
    ssp = _spans("ps.server/pull_sparse")[-1]
    # cross-"process" correlation: same trace id, parented to the call
    assert ssp.trace_id == csp.trace_id
    assert ssp.parent_id == csp.span_id
    assert ssp.attrs["outcome"] == "apply"
    assert csp.attrs["attempts"] == 1
    assert ssp.tid != csp.tid  # handler ran on the server's conn thread


def test_replayed_mutation_reuses_originating_trace_id(server):
    client = PSClient([server.endpoint], **FAST)
    grads = np.ones((2, DIM), np.float32)
    # drop exactly the first push reply: the request WAS applied, the
    # retry must hit the replay cache — both server spans one trace
    with faults.inject(faults.Fault("server", "reply", faults.DROP,
                                    method="push_sparse_grad")) as inj:
        client.push_sparse_grad("emb", [1, 2], grads)
    assert inj.fired(faults.DROP) == 1
    client.close()
    csp = _spans("ps.rpc/push_sparse_grad")[-1]
    server_spans = [s for s in _spans("ps.server/push_sparse_grad")
                    if s.trace_id == csp.trace_id]
    outcomes = [s.attrs["outcome"] for s in server_spans]
    assert outcomes == ["apply", "replay"], outcomes
    # the retry carried the SAME frame bytes: both server spans parent
    # to the one client span of the one logical call
    assert {s.parent_id for s in server_spans} == {csp.span_id}
    assert csp.attrs["attempts"] == 2
    assert csp.attrs["mutating"] is True
    # exactly-once still holds under the shared trace context
    assert client_applied(server) == 1


def client_applied(server):
    c = PSClient([server.endpoint], **FAST)
    try:
        return c.table_applied("emb")
    finally:
        c.close()


def test_span_survives_mid_call_reconnect(server):
    client = PSClient([server.endpoint], **FAST)
    # two resets at the send boundary force teardown + re-dial (and a
    # re-auth handshake path) INSIDE one logical call
    with faults.inject(faults.Fault("client", "send", faults.RESET,
                                    method="pull_sparse", times=2)) as inj:
        rows = client.pull_sparse("emb", [5, 6])
    assert rows.shape == (2, DIM)
    assert inj.fired(faults.RESET) == 2
    client.close()
    csp = _spans("ps.rpc/pull_sparse")[-1]
    assert csp.attrs["attempts"] == 3      # one span across all attempts
    assert csp.t1 is not None
    ssp = [s for s in _spans("ps.server/pull_sparse")
           if s.trace_id == csp.trace_id]
    # the attempt that finally landed still correlates to the call
    assert ssp and ssp[-1].parent_id == csp.span_id


def test_chaos_run_keeps_traces_connected(server):
    """Seeded chaos: every server-side span observed during the storm
    belongs to SOME client call span's trace (no orphan traces), and
    mutations stay exactly-once."""
    client = PSClient([server.endpoint], **FAST)
    grads = np.ones((3, DIM), np.float32)
    with faults.inject(seed=11, p={faults.RESET: 0.1, faults.DROP: 0.1}):
        for i in range(20):
            client.push_sparse_grad("emb", [i, i + 1, i + 2], grads)
    client.close()
    client_traces = {s.trace_id
                     for s in _spans("ps.rpc/push_sparse_grad")}
    server_spans = _spans("ps.server/push_sparse_grad")
    assert len(client_traces) == 20
    assert len(server_spans) >= 20
    orphans = [s for s in server_spans
               if s.trace_id not in client_traces]
    assert not orphans, f"server spans outside any call trace: {orphans}"
    assert client_applied(server) == 20


# ---------------------------------------- wire parity with the JAX package

from paddle_tpu.distributed import ps as jps  # noqa: E402
from paddle_tpu.distributed.ps import rpc as jrpc  # noqa: E402
from paddle_tpu_torch.distributed import ps as tps  # noqa: E402

PS = {"jax": jps, "port": tps}
WIRE_SPECS = {
    "emb": {"type": "sparse", "dim": DIM, "optimizer": "adagrad",
            "lr": 0.1, "init": "uniform", "seed": 3},
    "adam_emb": {"type": "sparse", "dim": DIM, "optimizer": "adam",
                 "lr": 0.01, "init": "normal", "seed": 4},
    "geo": {"type": "geo_sparse", "dim": DIM, "init": "zeros"},
    "dense0": {"type": "dense", "shape": (3, DIM), "optimizer": "adam",
               "lr": 0.01, "init": "zeros"},
}


def _wire_script(client, tensors):
    """Scripted pulls and pushes over two servers; grads depend on the
    pulled rows, so any difference compounds. ``tensors``: hand the
    grads to the client as torch tensors (the port's client only)."""
    wrap = torch.from_numpy if tensors else (lambda a: a)
    for step in range(6):
        rng = np.random.RandomState(50 + step)
        ids = rng.randint(0, 40, size=12).astype(np.int64)
        ids[3] = ids[7]                           # a duplicate id
        for table in ("emb", "adam_emb"):
            rows = client.pull_sparse(table, ids)
            g = rows * 0.1 + rng.randn(len(ids), DIM).astype(np.float32)
            client.push_sparse_grad(table, wrap(ids), wrap(g))
        client.push_sparse_delta(
            "geo", wrap(ids), wrap(rng.randn(len(ids), DIM)
                                   .astype(np.float32)))
        d = client.pull_dense("dense0")
        client.push_dense_grad("dense0", wrap(
            d * 0.5 + rng.randn(3, DIM).astype(np.float32)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _wire_state(servers):
    out = {}
    for k, s in enumerate(servers):
        for name in WIRE_SPECS:
            t = s.table(name)
            out[(k, name, "applied")] = np.asarray(t.applied)
            for path, leaf in _leaves(t.state()):
                out[(k, name) + path] = leaf
    return out


def _wire_run(server_pkg, client_pkg, tensors=False):
    servers = [PS[server_pkg].PSServer("127.0.0.1:0", WIRE_SPECS)
               for _ in range(2)]
    eps = [s.start() for s in servers]
    client = PS[client_pkg].PSClient(eps, **FAST)
    try:
        _wire_script(client, tensors)
        return _wire_state(servers)
    finally:
        client.close()
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("server_pkg,client_pkg,tensors", [
    ("jax", "port", False), ("jax", "port", True), ("port", "jax", False),
    ("port", "port", True)])
def test_cross_package_peers_give_jax_tables_bitwise(server_pkg,
                                                     client_pkg, tensors):
    """Either package's client against either package's server: the
    same table state, bitwise, and the same ``applied`` counts as the
    JAX client against the JAX server."""
    want = _wire_run("jax", "jax")
    got = _wire_run(server_pkg, client_pkg, tensors)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


def test_frames_are_the_jax_packages_bytes():
    req = {"method": "push_sparse_grad", "table": "emb",
           "ids": np.arange(5, dtype=np.int64),
           "grads": np.linspace(-1, 1, 20, dtype=np.float32).reshape(5, 4),
           "__rid__": ("c0ffee", 7), "__trace__": ("t", None)}
    assert rpc._pack(req) == jrpc._pack(req)
    assert rpc._SAFE_GLOBALS == jrpc._SAFE_GLOBALS


def test_torch_tensor_never_rides_the_wire(server):
    """A raw torch tensor in a frame is refused by the restricted
    unpickler of either package's server; the port's client turns one
    into numpy before the wire."""
    import pickle
    for mod in (rpc, jrpc):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            mod._unpack(rpc._pack({"g": torch.ones(2)}))
    client = PSClient([server.endpoint], **FAST)
    try:
        client.push_sparse_grad("emb", torch.tensor([1, 2]),
                                torch.ones(2, DIM, dtype=torch.bfloat16))
        np.testing.assert_array_equal(client.pull_sparse("emb", [1, 2]),
                                      -np.ones((2, DIM), np.float32))
    finally:
        client.close()


def test_ps_and_telemetry_modules_import_neither_jax_nor_the_jax_package():
    """In a process where importing jax or paddle_tpu fails, the PS tier,
    the telemetry plane and the harness import, and a port server and
    client exchange a pull."""
    import os
    import subprocess
    import sys
    import textwrap
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mods = ["paddle_tpu_torch.distributed.ps"] + [
        f"paddle_tpu_torch.distributed.ps.{m}" for m in (
            "rpc", "shard_map", "table", "replica", "server", "client",
            "embedding", "heter", "publish")] + [
        "paddle_tpu_torch.core.telemetry", "paddle_tpu_torch.traffic.harness",
        "paddle_tpu_torch.static.executor"]
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        sys.path.insert(0, {repo!r})
        for m in {mods!r}:
            importlib.import_module(m)
        from paddle_tpu_torch.distributed.ps import PSClient, PSServer
        srv = PSServer(tables={{"t": {{"type": "sparse", "dim": 2,
                                       "init": "zeros"}}}})
        c = PSClient([srv.start()])
        print(c.pull_sparse("t", [1, 2]).shape)
        c.close(); srv.shutdown()
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(2,", "2)"]
