"""Elastic kill-and-resume drill (tools/elastic_drill.py for the port):
prove, end to end, that a trainer SIGKILLed mid-epoch — no grace, not
SIGTERM — is a non-event.

The drill spins an in-process PS cluster, then supervises a trainer
SUBPROCESS (distributed/elastic.py Supervisor) running a PS-backed,
pipelined training loop (static PipelineRunner hot loop + per-step
PSClient pushes under checkpoint-persisted replay keys, verified
auto-checkpoints every few steps). On its first attempt the trainer
SIGKILLs itself at the seeded kill step; the supervisor restarts it; the
restarted trainer restores the newest VERIFIED checkpoint (params,
optimizer slots, rng chain, PSClient replay identity, data cursor),
replays its in-doubt steps — whose re-sent pushes DEDUPE server-side —
and finishes. The drill then asserts the final params and every server's
`table.applied` counters are bitwise-equal to an uninterrupted reference
run, and reports the recovery timeline.

Run:  python -m paddle_tpu_torch.tools.elastic_drill [workdir]
Also: python -m paddle_tpu_torch.tools.elastic_drill trainer     # internal
      python -m paddle_tpu_torch.tools.elastic_drill self_check

The trainer runs on the CPU.
``self_check()`` holds the PADDLE_ELASTIC_* / PADDLE_CKPT_VERIFY flag
defaults against this drill's and the ``chaos`` marker on the port's
elastic tests (``tests/test_torch_elastic.py``).
"""
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# ---------------------------------------------------------------- knobs
# (env-overridable; the test pins the same schedule)
DRILL_STEPS = int(os.environ.get("PADDLE_DRILL_STEPS", 14))
DRILL_SAVE_EVERY = int(os.environ.get("PADDLE_DRILL_SAVE_EVERY", 4))
DRILL_SEED = int(os.environ.get("PADDLE_DRILL_SEED", 11))
DRILL_BATCH = 8
DRILL_VOCAB = 40
DRILL_DIM = 4

# flag defaults this drill (and the docs flag table) are written
# against; drift means docs/fault_tolerance.md + this header need an
# update — self_check() pins all three together
ELASTIC_FLAG_DEFAULTS = {
    "PADDLE_ELASTIC_MAX_RESTARTS": 3,
    "PADDLE_ELASTIC_RESTART_BACKOFF_S": 1.0,
    "PADDLE_ELASTIC_STALL_TIMEOUT_S": 300.0,
    "PADDLE_ELASTIC_HEARTBEAT_TIMEOUT_S": 60.0,
    "PADDLE_CKPT_VERIFY": True,
}

FAST_RPC = dict(timeout=10.0, max_retries=2, backoff_base=0.01,
                backoff_max=0.05, connect_retry_s=10.0)


def kill_step_for(seed, steps=None, save_every=None):
    """The seeded mid-epoch kill step: strictly after the first
    checkpoint, strictly before the epoch end, and NOT on a checkpoint
    boundary — the in-doubt replay window is what the drill exists to
    exercise."""
    steps = steps or DRILL_STEPS
    save_every = save_every or DRILL_SAVE_EVERY
    rng = np.random.RandomState(seed)
    while True:
        k = int(rng.randint(save_every + 1, steps - 1))
        if k % save_every:
            return k


def table_specs():
    return {"emb": {"type": "sparse", "dim": DRILL_DIM,
                    "optimizer": "sgd", "lr": 1.0, "init": "zeros"},
            "dense0": {"type": "dense", "shape": (3, DRILL_DIM),
                       "optimizer": "sgd", "lr": 0.1, "init": "zeros"}}


# ------------------------------------------------------------- trainer

def run_trainer():
    """The supervised trainer: static pipelined executor + per-step PS
    pushes + verified auto-checkpoints + heartbeat. Reads its wiring
    from PADDLE_DRILL_* env (set by the supervisor side)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, ops, optimizer, static
    from paddle_tpu_torch.core import rng as _rng
    from paddle_tpu_torch.device import set_device
    from paddle_tpu_torch.distributed.elastic import Heartbeat
    from paddle_tpu_torch.distributed.ps import PSClient
    from paddle_tpu_torch.incubate.checkpoint import TrainingCheckpoint
    from paddle_tpu_torch.static import PipelineRunner

    eps = os.environ["PADDLE_DRILL_ENDPOINTS"].split(",")
    ckpt_dir = os.environ["PADDLE_DRILL_CKPT"]
    out_path = os.environ["PADDLE_DRILL_OUT"]
    steps = int(os.environ.get("PADDLE_DRILL_STEPS", DRILL_STEPS))
    save_every = int(os.environ.get("PADDLE_DRILL_SAVE_EVERY",
                                    DRILL_SAVE_EVERY))
    kill_step = int(os.environ.get("PADDLE_DRILL_KILL_STEP", -1))
    marker = os.environ.get("PADDLE_DRILL_KILL_MARKER", "")
    hb_dir = os.environ.get("PADDLE_ELASTIC_HEARTBEAT_DIR", "")

    set_device("cpu")
    paddle.enable_static()
    paddle.seed(1234)
    prog = static.Program("elastic_drill")
    with static.program_guard(prog, static.Program()):
        x = static.data("x", [-1, 4], "float32")
        y = static.data("y", [-1, 1], "float32")
        h = ops.relu(nn.Linear(4, 8)(x))
        loss = ops.mse_loss(nn.Linear(8, 1)(h), y)
        opt = optimizer.Adam(learning_rate=0.05)
        opt.minimize(loss)
    exe = static.Executor()
    scope = static.global_scope()
    param_names = list(prog.persist_ids)

    # deterministic data schedule: batch k is a fixed slice, so a
    # restarted trainer replays the exact batches (the data cursor IS
    # the step counter here; DataLoader-based jobs checkpoint
    # state_dict() instead)
    drng = np.random.RandomState(7)
    X = drng.rand(steps * DRILL_BATCH, 4).astype(np.float32)
    Y = drng.rand(steps * DRILL_BATCH, 1).astype(np.float32)

    # JOB-stable replay identity: (client_id, step-key) must name the
    # same logical mutation across process death — a restart that finds
    # no committed checkpoint yet (death raced the first async save)
    # still dedupes its re-sent pushes. The checkpointed replay_state
    # then carries the auto-minted seq forward too.
    client = PSClient(eps, client_id="drill-trainer-0", **FAST_RPC)
    ckpt = TrainingCheckpoint(ckpt_dir, keep=3, async_save=True)

    def capture(done):
        rs = client.replay_state()
        return {
            "params": {n: scope.get(n).detach().cpu().numpy().copy()
                       for n in param_names},
            "optimizer": {k: (v.detach().cpu().numpy().copy()
                              if hasattr(v, "detach") else v)
                          for k, v in opt.state_dict().items()},
            "rng_key": _rng.generator("cpu").get_state().numpy().copy(),
            "ps": {"client_id": np.frombuffer(
                       rs["client_id"].encode("ascii"),
                       np.uint8).copy(),
                   "seq": int(rs["seq"])},
            "counters": {"step": int(done)},
            "data": {"cursor": int(done)},
        }

    start_step = 0
    state = ckpt.restore()   # verified; walks back over corrupt steps
    if state is not None:
        for n in param_names:
            scope.set(n, torch.as_tensor(np.asarray(state["params"][n]),
                                         device=scope.get(n).device))
        opt.set_state_dict(state["optimizer"])
        _rng.generator("cpu").set_state(torch.as_tensor(
            np.asarray(state["rng_key"], np.uint8)))
        client.load_replay_state(state["ps"])
        start_step = int(np.asarray(state["counters"]["step"]))
        print(f"[drill-trainer] resumed from step {start_step}",
              flush=True)

    hb = None
    if hb_dir:
        hb = Heartbeat(hb_dir, rank=0, interval_s=0.2).start()

    def ps_step(step):
        """Deterministic PS traffic whose grads depend on PULLED state —
        one lost or double-applied push poisons every later step. The
        replay key is (client_id, step): persisted through the
        checkpoint, so re-sent in-doubt pushes dedupe server-side."""
        r = np.random.RandomState(1000 + step)
        ids = r.randint(0, DRILL_VOCAB, size=8).astype(np.int64)
        rows = client.pull_sparse("emb", ids)
        grads = rows * 0.05 + r.randn(len(ids), DRILL_DIM).astype(
            np.float32)
        client.push_sparse_grad("emb", ids, grads,
                                request_key=f"step{step}")
        dense = client.pull_dense("dense0")
        client.push_dense_grad(
            "dense0",
            dense * 0.05 + r.randn(3, DRILL_DIM).astype(np.float32),
            request_key=f"step{step}")

    with PipelineRunner(exe, prog, fetch_list=[loss],
                        max_inflight=2) as runner:
        for step in range(start_step, steps):
            lo = step * DRILL_BATCH
            runner.submit({"x": X[lo:lo + DRILL_BATCH],
                           "y": Y[lo:lo + DRILL_BATCH]})
            ps_step(step)
            done = step + 1
            if marker and done == kill_step \
                    and not os.path.exists(marker):
                # die for real: SIGKILL, no grace, mid-epoch, with the
                # steps since the last checkpoint in doubt. Waiting out
                # the previous ASYNC commit first only makes the test
                # deterministic about which checkpoint survives — the
                # in-doubt replay window is untouched (death racing the
                # commit itself is test_sigkill_during_async_save's job)
                ckpt.wait()
                with open(marker, "w") as f:
                    f.write(str(done))
                os.kill(os.getpid(), 9)
            if done % save_every == 0 or done == steps:
                runner.sync()   # drain in-flight, write back the carry
                ckpt.save(done, capture(done))
    ckpt.wait()
    if hb is not None:
        hb.stop()
    np.savez(out_path,
             **{f"param_{i}": scope.get(n).detach().cpu().numpy()
                for i, n in enumerate(param_names)})
    client.close()
    return 0


# ----------------------------------------------------- supervisor side

def start_cluster():
    from paddle_tpu_torch.distributed.ps import PSServer
    servers = [PSServer("127.0.0.1:0", table_specs()) for _ in range(2)]
    eps = [s.start() for s in servers]
    return servers, eps


def final_ps_state(eps):
    from paddle_tpu_torch.distributed.ps import PSClient
    c = PSClient(eps, **FAST_RPC)
    try:
        sparse = c.pull_sparse("emb",
                               np.arange(DRILL_VOCAB, dtype=np.int64))
        dense = c.pull_dense("dense0")
        return np.asarray(sparse).copy(), np.asarray(dense).copy()
    finally:
        c.close()


def run_supervised(workdir, kill=True, steps=DRILL_STEPS,
                   save_every=DRILL_SAVE_EVERY, seed=DRILL_SEED,
                   max_restarts=3):
    """One full supervised run against a fresh in-process cluster;
    returns (params dict, sparse, dense, applied {server: {table: n}},
    supervisor events)."""
    import subprocess

    from paddle_tpu_torch.distributed.elastic import Supervisor

    servers, eps = start_cluster()
    tag = "chaos" if kill else "ref"
    out = os.path.join(workdir, f"out_{tag}.npz")
    hb_dir = os.path.join(workdir, f"hb_{tag}")
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               PADDLE_DRILL_ENDPOINTS=",".join(eps),
               PADDLE_DRILL_CKPT=os.path.join(workdir, f"ckpt_{tag}"),
               PADDLE_DRILL_OUT=out,
               PADDLE_DRILL_STEPS=str(steps),
               PADDLE_DRILL_SAVE_EVERY=str(save_every),
               PADDLE_ELASTIC_HEARTBEAT_DIR=hb_dir)
    if kill:
        env["PADDLE_DRILL_KILL_STEP"] = str(
            kill_step_for(seed, steps, save_every))
        env["PADDLE_DRILL_KILL_MARKER"] = os.path.join(
            workdir, f"killed_{tag}")
    try:
        def start_rank(rank):
            return subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.tools.elastic_drill",
                 "trainer"], env=env, cwd=REPO)

        sup = Supervisor(start_rank, nranks=1, heartbeat_dir=hb_dir,
                         max_restarts=max_restarts, backoff_s=0.1,
                         heartbeat_timeout_s=60.0,
                         stall_timeout_s=300.0, poll_s=0.1)
        rc = sup.run()
        assert rc == 0
        with np.load(out) as z:
            params = {k: z[k].copy() for k in z.files}
        sparse, dense = final_ps_state(eps)
        applied = {i: {t: s.table(t).applied for t in ("emb", "dense0")}
                   for i, s in enumerate(servers)}
        return params, sparse, dense, applied, list(sup.events)
    finally:
        for s in servers:
            s.shutdown()


def run_drill(workdir=None):
    import tempfile

    from paddle_tpu_torch.core import monitor

    workdir = workdir or tempfile.mkdtemp(prefix="elastic_drill_")
    k = kill_step_for(DRILL_SEED)
    print(f"[drill] workdir={workdir} steps={DRILL_STEPS} "
          f"save_every={DRILL_SAVE_EVERY} kill_step={k}")

    t0 = time.perf_counter()
    ref = run_supervised(workdir, kill=False)
    t_ref = time.perf_counter() - t0
    print(f"[drill] reference run: {t_ref:.1f}s, "
          f"applied={ref[3]}")

    replays0 = monitor.stat_get("ps.rpc.replays")
    t0 = time.perf_counter()
    chaos = run_supervised(workdir, kill=True)
    t_chaos = time.perf_counter() - t0
    replays = monitor.stat_get("ps.rpc.replays") - replays0

    problems = []
    if not chaos[4]:
        problems.append("supervisor recorded no restart")
    for key in ref[0]:
        if not np.array_equal(ref[0][key], chaos[0][key]):
            problems.append(f"param {key} differs from fault-free run")
    if not np.array_equal(ref[1], chaos[1]):
        problems.append("sparse table differs from fault-free run")
    if not np.array_equal(ref[2], chaos[2]):
        problems.append("dense table differs from fault-free run")
    if ref[3] != chaos[3]:
        problems.append(f"applied counters differ: ref={ref[3]} "
                        f"chaos={chaos[3]}")
    if replays < 1:
        problems.append("no server-side replay was exercised — the kill "
                        "left no in-doubt pushes (bad kill placement?)")

    print(f"[drill] chaos run: {t_chaos:.1f}s "
          f"(+{t_chaos - t_ref:.1f}s recovery overhead), "
          f"restarts={[e[2] for e in chaos[4]]}, "
          f"in-doubt replays deduped={int(replays)}")
    if problems:
        print("[drill] FAILED:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print("[drill] OK: SIGKILL at a mid-epoch step was a non-event — "
          "params and per-server applied counters bitwise-equal")
    return 0


# ----------------------------------------------------------- self_check

def self_check():
    """The flag defaults against this drill's knobs, and the ``chaos``
    marker on the port's elastic tests. Returns a list of violations."""
    problems = []
    from paddle_tpu_torch.core import flags as _flags
    for name, want in ELASTIC_FLAG_DEFAULTS.items():
        defn = _flags._DEFS.get(name)
        if defn is None:
            problems.append(f"elastic_drill: flag {name} is no longer "
                            "defined in core/flags.py")
            continue
        if defn[1] != want:
            problems.append(
                f"elastic_drill: {name} default drifted "
                f"({defn[1]!r} != {want!r}) — update "
                "ELASTIC_FLAG_DEFAULTS")
    test_path = os.path.join(REPO, "tests", "test_torch_elastic.py")
    try:
        with open(test_path) as f:
            test_src = f.read()
    except OSError:
        return problems + ["elastic_drill: tests/test_torch_elastic.py is "
                           "missing — the SIGKILL recovery proof must "
                           "stay tier-1"]
    if "pytest.mark.chaos" not in test_src:
        problems.append("elastic_drill: tests/test_torch_elastic.py lost "
                        "its `chaos` marker")
    return problems


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "trainer":
        return run_trainer()
    if argv and argv[0] == "self_check":
        problems = self_check()
        for p in problems:
            print(p)
        print("elastic_drill self_check: "
              + ("clean" if not problems else f"{len(problems)} issue(s)"))
        return 1 if problems else 0
    return run_drill(argv[0] if argv else None)


if __name__ == "__main__":
    sys.exit(main())
