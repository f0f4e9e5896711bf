"""Port parity: elastic restarts and the launcher
(paddle_tpu_torch/distributed/{elastic,launch}.py) against the JAX
package's.

- The Supervisor, Heartbeat, StallMonitor, ``_reap`` and ``notify_step``
  behave as the JAX package's (the counterparts of
  ``tests/test_elastic_resume.py:453-626``), with heartbeat deadlines of
  2 s or more; a process group restarts whole (``group=True``).
- ``launch_ps``: a PS job whose worker dies on its first attempt
  restarts and recovers its table from the snapshot (the counterpart of
  ``tests/test_launch_ps.py``).
- ``launch``: a 2-rank data-parallel ``Model.fit`` of tiny BERT (gloo,
  auto-checkpoint every 2 steps) whose rank 1 SIGKILLs itself after step
  3 on attempt 0 restarts whole, resumes from step 2 on both ranks, and
  ends with per-step losses and parameters bitwise those of the same
  launch without the kill.
"""
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from paddle_tpu_torch.core import monitor

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_ENV = dict(os.environ,
                 PYTHONPATH=f"{REPO}{os.pathsep}"
                            f"{os.environ.get('PYTHONPATH', '')}")

_STALL_SCRIPT = textwrap.dedent("""
    import json, os, sys, time
    hb, cnt = sys.argv[1], sys.argv[2]
    n = int(open(cnt).read()) if os.path.exists(cnt) else 0
    with open(cnt, "w") as f:
        f.write(str(n + 1))
    if n >= 1:
        sys.exit(0)
    os.makedirs(hb, exist_ok=True)
    t0 = time.time()
    while time.time() - t0 < 60:
        tmp = os.path.join(hb, "heartbeat_0.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"rank": 0, "step": 5, "time": time.time()}, f)
        os.replace(tmp, os.path.join(hb, "heartbeat_0.json"))
        time.sleep(0.05)
""")


def test_supervisor_restarts_stalled_trainer(tmp_path):
    from paddle_tpu_torch.distributed.elastic import Supervisor
    script = tmp_path / "stall.py"
    script.write_text(_STALL_SCRIPT)
    hb, cnt = str(tmp_path / "hb"), str(tmp_path / "attempts")

    def start(rank):
        return subprocess.Popen([sys.executable, str(script), hb, cnt])

    stalls0 = monitor.stat_get("elastic.stalls")
    sup = Supervisor(start, nranks=1, heartbeat_dir=hb, max_restarts=2,
                     backoff_s=0.05, heartbeat_timeout_s=30.0,
                     stall_timeout_s=2.0, poll_s=0.1)
    assert sup.run() == 0
    assert any("stalled" in e[2] for e in sup.events), sup.events
    assert monitor.stat_get("elastic.stalls") > stalls0
    assert int(open(cnt).read()) == 2


def test_supervisor_exhausted_budget_raises():
    from paddle_tpu_torch.distributed.elastic import Supervisor

    def start(rank):
        return subprocess.Popen([sys.executable, "-c",
                                 "import sys; sys.exit(3)"])

    sup = Supervisor(start, nranks=1, max_restarts=1, backoff_s=0.01,
                     poll_s=0.05)
    with pytest.raises(SystemExit) as ei:
        sup.run()
    assert ei.value.code == 3
    assert sup.restarts[0] == 2


def test_reap_escalates_term_to_kill():
    from paddle_tpu_torch.distributed.elastic import _reap
    p = subprocess.Popen([sys.executable, "-c", textwrap.dedent("""
        import signal, time
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        print("armed", flush=True)
        time.sleep(120)
    """)], stdout=subprocess.PIPE, text=True)
    assert p.stdout.readline().strip() == "armed"
    t0 = time.monotonic()
    _reap([p], grace_s=1.0)
    assert time.monotonic() - t0 < 30
    assert p.poll() == -signal.SIGKILL


def test_supervisor_ignores_previous_incarnation_beats(tmp_path):
    from paddle_tpu_torch.distributed.elastic import Supervisor
    hb = str(tmp_path / "hb")
    os.makedirs(hb)
    with open(os.path.join(hb, "heartbeat_0.json"), "w") as f:
        json.dump({"rank": 0, "step": 3, "time": time.time() - 1000}, f)
    script = textwrap.dedent("""
        import json, os, sys, time
        hb = sys.argv[1]
        time.sleep(0.5)
        tmp = os.path.join(hb, "heartbeat_0.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"rank": 0, "step": 1, "time": time.time()}, f)
        os.replace(tmp, os.path.join(hb, "heartbeat_0.json"))
    """)

    def start(rank):
        return subprocess.Popen([sys.executable, "-c", script, hb])

    sup = Supervisor(start, nranks=1, heartbeat_dir=hb, max_restarts=3,
                     backoff_s=0.05, heartbeat_timeout_s=2.0,
                     stall_timeout_s=300.0, poll_s=0.05)
    assert sup.run() == 0
    assert sup.events == []


def test_supervisor_restarts_a_process_group_whole(tmp_path):
    """group=True: rank 1 dies on its first incarnation; every rank is
    reaped and started again, and the job ends once both exit 0 on the
    second incarnation."""
    from paddle_tpu_torch.distributed.elastic import Supervisor
    log = tmp_path / "starts"
    script = textwrap.dedent("""
        import os, sys, time
        rank, log = int(sys.argv[1]), sys.argv[2]
        with open(log, "a") as f:
            f.write(f"{rank}\\n")
        n = sum(1 for line in open(log) if line.strip() == str(rank))
        if rank == 1 and n == 1:
            time.sleep(0.3)
            os._exit(9)
        if rank == 0 and n == 1:
            time.sleep(60)          # a peer blocked on the dead rank
        sys.exit(0)
    """)

    def start(rank):
        return subprocess.Popen([sys.executable, "-c", script, str(rank),
                                 str(log)])

    sup = Supervisor(start, nranks=2, max_restarts=2, backoff_s=0.05,
                     poll_s=0.05, group=True)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 30
    starts = open(log).read().split()
    assert sorted(starts[:2]) == sorted(starts[2:]) == ["0", "1"]
    assert sup.group_restarts == 1 and sup.restarts[1] == 1
    assert "exited rc=9" in sup.events[0][2]


def test_heartbeat_beat_thread_writes_live_step(tmp_path):
    from paddle_tpu_torch.distributed import elastic
    step = {"n": 0}
    hb = elastic.Heartbeat(str(tmp_path), rank=0, interval_s=0.05,
                           step_fn=lambda: step["n"]).start()
    try:
        step["n"] = 41
        deadline = time.monotonic() + 5
        path = os.path.join(str(tmp_path), "heartbeat_0.json")
        got = None
        while time.monotonic() < deadline:
            with open(path) as f:
                got = json.load(f)["step"]
            if got == 41:
                break
            time.sleep(0.02)
        assert got == 41
        assert elastic.Heartbeat.check(str(tmp_path), timeout_s=60) == []
        assert monitor.stat_get("elastic.heartbeat_age_s") >= 0
    finally:
        hb.stop()


def test_heartbeat_check_counts_a_corrupt_beat_stale(tmp_path):
    from paddle_tpu_torch.distributed import elastic
    (tmp_path / "heartbeat_3.json").write_text("{not json")
    (tmp_path / "heartbeat_1.json").write_text(json.dumps(
        {"rank": 1, "step": 2, "time": time.time()}))
    assert elastic.Heartbeat.read(str(tmp_path))[3] is None
    assert elastic.Heartbeat.check(str(tmp_path), timeout_s=60) == [3]


def test_notify_step_reaches_registered_listeners(tmp_path):
    from paddle_tpu_torch.distributed import elastic
    mon = elastic.StallMonitor(timeout_s=300.0).start()
    hb = elastic.Heartbeat(str(tmp_path), rank=0, interval_s=60.0).start()
    try:
        before = mon._last
        time.sleep(0.01)
        elastic.notify_step(17)
        assert mon._last > before
        assert hb._step == 17
    finally:
        mon.stop()
        hb.stop()


def test_stall_monitor_default_flight_records(tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed.elastic import StallMonitor
    monkeypatch.setenv("PADDLE_TPU_DUMP_DIR", str(tmp_path))
    before = monitor.stat_get("elastic.stalls")
    m = StallMonitor(timeout_s=300.0)
    m.on_stall(12.5)
    assert monitor.stat_get("elastic.stalls") == before + 1
    assert glob.glob(os.path.join(str(tmp_path), "obsdump_stall_*"))


def test_fit_pulses_the_step_listeners(tmp_path):
    """Model.fit's step pulse (the JAX engine's notify_step in fit): a
    Heartbeat started beside it counts the steps."""
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.io import TensorDataset
    hb = elastic.Heartbeat(str(tmp_path), rank=0, interval_s=60.0).start()
    try:
        with device_scope("cpu"):
            net = pt.nn.Linear(4, 1)
            model = pt.Model(net)
            model.prepare(pt.optimizer.SGD(learning_rate=0.1,
                                           parameters=net.parameters()),
                          loss=pt.nn.MSELoss())
            x = np.random.RandomState(0).rand(12, 4).astype("float32")
            model.fit(TensorDataset([x, x[:, :1]]), batch_size=4,
                      epochs=1, verbose=0)
        assert hb._step == 3
    finally:
        hb.stop()
    del torch


def test_build_env_gives_the_rank_contract():
    from paddle_tpu_torch.distributed import bootstrap, launch
    eps = ["127.0.0.1:7000", "127.0.0.1:7001"]
    env = launch._build_env(1, 2, eps, attempt=1, cards=1)
    assert env["PADDLE_TRAINER_ID"] == "1"
    assert env["PADDLE_TRAINERS_NUM"] == "2"
    assert env["PADDLE_CURRENT_ENDPOINT"] == eps[1]
    assert env["PADDLE_LOCAL_SIZE"] == "2"
    assert env["PADDLE_LOCAL_RANK"] == "1"
    assert env["FLAGS_selected_gpus"] == "0"     # 2 ranks, 1 card
    assert env["PADDLE_LAUNCH_ATTEMPT"] == "1"
    assert launch._build_env(1, 2, eps, cards=0)["FLAGS_selected_gpus"] \
        == "1"
    old = {k: os.environ.get(k) for k in ("PADDLE_LOCAL_SIZE",
                                          "PADDLE_LOCAL_RANK")}
    os.environ.update(PADDLE_LOCAL_SIZE="2", PADDLE_LOCAL_RANK="1")
    try:
        assert bootstrap.local_ranks(1, 2, eps) == (2, 1)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_a_later_attempt_moves_off_a_bound_rendezvous():
    from paddle_tpu_torch.distributed import launch
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    port = s.getsockname()[1]
    try:
        first = launch._endpoints("127.0.0.1", port, 2)
        assert first[0] == f"127.0.0.1:{port}"
        again = launch._endpoints("127.0.0.1", port - 2, 2, attempt=1)
        assert again[0] != f"127.0.0.1:{port}"
        assert launch._bindable("127.0.0.1",
                                int(again[0].rsplit(":", 1)[1]))
    finally:
        s.close()


def test_launch_main_parses_the_reference_flags(monkeypatch):
    from paddle_tpu_torch.distributed import launch
    seen = {}
    monkeypatch.setattr(launch, "launch",
                        lambda *a, **k: seen.setdefault("launch", (a, k)))
    monkeypatch.setattr(launch, "launch_ps",
                        lambda *a, **k: seen.setdefault("ps", (a, k)))
    launch.main(["--nproc_per_node", "2", "--elastic_retries", "1",
                 "job.py", "--x", "1"])
    a, k = seen["launch"]
    assert a == ("job.py", ["--x", "1"], 2) and k["elastic_retries"] == 1
    launch.main(["--server_num", "1", "--worker_num", "2", "job.py"])
    assert seen["ps"][1]["worker_num"] == 2


_PS_SCRIPT = textwrap.dedent("""
    import os, sys
    import numpy as np

    role = os.environ["TRAINING_ROLE"]
    attempt = int(os.environ.get("PADDLE_LAUNCH_ATTEMPT", "0"))
    workdir = sys.argv[1]
    snap = os.path.join(workdir, "snap")

    if role == "PSERVER":
        from paddle_tpu_torch.distributed.ps import PSServer
        port = os.environ["PADDLE_PORT"]
        srv = PSServer(endpoint=f"127.0.0.1:{port}", tables={
            "emb": {"type": "sparse", "dim": 4, "optimizer": "sgd",
                    "lr": 1.0, "init": "zeros"}})
        srv.start()
        srv.run()
        sys.exit(0)

    from paddle_tpu_torch.distributed.ps import PSClient
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    client = PSClient(os.environ["PADDLE_PSERVERS_IP_PORT_LIST"].split(","))
    ids = np.arange(4, dtype=np.int64)
    if attempt > 0 and rank == 0 and os.path.exists(snap + ".s0"):
        client.load_snapshot(snap)
    client.pull_sparse("emb", ids)
    client.push_sparse_grad("emb", ids, np.ones((4, 4), np.float32))
    if rank == 0:
        client.save_snapshot(snap)
    if attempt == 0 and rank == 0:
        os._exit(7)
    client.push_sparse_grad("emb", ids, np.ones((4, 4), np.float32))
    rows = client.pull_sparse("emb", ids)
    if rank == 0 and attempt > 0:
        assert (np.asarray(rows) <= -2.999).all(), np.asarray(rows)
    with open(os.path.join(workdir, f"ok_{rank}_{attempt}"), "w") as f:
        f.write("done")
    if rank == 0:
        import time
        peer = os.path.join(workdir, f"ok_1_{attempt}")
        deadline = time.time() + 60
        while not os.path.exists(peer) and time.time() < deadline:
            time.sleep(0.1)
        client.stop_servers()
    client.close()
    sys.exit(0)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_launch_ps_kill_worker_recovers(tmp_path):
    script = tmp_path / "ps_job.py"
    script.write_text(_PS_SCRIPT)
    code = ("from paddle_tpu_torch.distributed.launch import launch_ps; "
            f"launch_ps({str(script)!r}, ({str(tmp_path)!r},), "
            f"server_num=1, worker_num=2, start_port={_free_port()}, "
            "elastic_retries=2)")
    r = subprocess.run([sys.executable, "-c", code], env=CHILD_ENV,
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"launch failed:\n{r.stdout}\n{r.stderr}"
    assert "elastic restart 1/2" in r.stdout
    oks = sorted(os.path.basename(f)
                 for f in glob.glob(str(tmp_path / "ok_*")))
    assert any(f.startswith("ok_0_") and not f.endswith("_0")
               for f in oks), oks
    assert any(f.startswith("ok_1_") for f in oks), oks


def _launch_fit(out, port, kill):
    job = os.path.join(REPO, "paddle_tpu_torch", "testing", "fit_job.py")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--started_port", str(port)]
    if kill:
        cmd += ["--elastic_retries", "1"]
    cmd += [job, "--out", str(out), "--steps", "6", "--batch", "8",
            "--seq", "16", "--device", "cpu"]
    if kill:
        cmd += ["--kill-after", "3"]
    env = dict(CHILD_ENV, OMP_NUM_THREADS="2")
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=600)


def test_launch_restarts_a_killed_collective_job_bitwise(tmp_path):
    ref = _launch_fit(tmp_path / "ref", _free_port(), kill=False)
    assert ref.returncode == 0, ref.stderr[-3000:]
    got = _launch_fit(tmp_path / "kill", _free_port(), kill=True)
    assert got.returncode == 0, got.stderr[-3000:]
    assert "elastic restart 1/1" in got.stdout
    killed = json.load(open(tmp_path / "kill" / "killed.json"))
    assert killed["after"] == 3
    for r in (0, 1):
        want = json.load(open(tmp_path / "ref" / f"rank{r}_attempt0.json"))
        resumed = json.load(open(tmp_path / "kill"
                                 / f"rank{r}_attempt1.json"))
        # both ranks resume from the step-2 checkpoint: step index 2 on
        assert sorted(resumed["losses"], key=int) == ["2", "3", "4", "5"]
        for k, v in resumed["losses"].items():
            assert v == want["losses"][k], (r, k)
        a = np.load(tmp_path / "ref" / f"rank{r}.npz")
        b = np.load(tmp_path / "kill" / f"rank{r}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    first = json.load(open(tmp_path / "kill" / "rank1_attempt0.json"))
    for k, v in first["losses"].items():
        assert v == json.load(open(tmp_path / "ref" /
                                   "rank1_attempt0.json"))["losses"][k]
