"""Process launcher: ``python -m paddle_tpu_torch.distributed.launch
train.py`` (paddle_tpu/distributed/launch.py).

The JAX launcher starts one process per host, whose single controller
drives every chip there. The port runs one process per rank, so
``--nproc_per_node N`` starts N processes, each with the PADDLE_* contract
that ``env.py`` and ``bootstrap.py`` read: rank, world size, the
endpoints (rank 0's is the rendezvous), ``PADDLE_LOCAL_SIZE`` /
``PADDLE_LOCAL_RANK`` (which the backend choice counts: NCCL when each
rank of the node has a card, gloo when ranks share one) and
``FLAGS_selected_gpus`` (the local rank modulo the node's card count).

Restarts: ``launch(elastic_retries=k)`` restarts the whole job up to k
times (trainers resume from their auto-checkpoint); ``launch_elastic``
(``--elastic``) hands the ranks to ``elastic.Supervisor``, which restarts
a process group whole; ``launch_ps`` restarts servers and workers.
Every attempt of a collective job rendezvouses afresh: the endpoints move
to free ports when the previous attempt's are still bound, a
``file://`` init method gets a file of its own, and
``PADDLE_LAUNCH_ATTEMPT`` tells the trainers which attempt they are.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

from .elastic import Supervisor, _reap

__all__ = ["launch", "launch_elastic", "launch_ps", "main"]


def _card_count() -> int:
    try:
        import torch
        return int(torch.cuda.device_count())
    except Exception:
        return 0


def _build_env(rank, nranks, endpoints, attempt=0, cards=None):
    env = dict(os.environ)
    cards = _card_count() if cards is None else int(cards)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nranks),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "PADDLE_RANK_IN_NODE": str(rank),
        "PADDLE_LOCAL_SIZE": str(nranks),
        "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_LAUNCH_ATTEMPT": str(attempt),
        "FLAGS_selected_gpus": str(rank % cards if cards > 0 else rank),
    })
    init = os.environ.get("PADDLE_DIST_INIT_METHOD", "")
    if init.startswith("file://") and attempt:
        # a FileStore of a dead attempt holds its keys: a file of its own
        env["PADDLE_DIST_INIT_METHOD"] = f"{init}.{attempt}"
    return env


def _bindable(host, port) -> bool:
    s = socket.socket()
    try:
        s.bind((host, port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def _endpoints(host, start_port, n, attempt=0):
    """n endpoints from ``start_port``; a later attempt whose rendezvous
    port is still bound (a dead rank 0's store) moves the block up."""
    port = start_port
    if attempt:
        port = start_port + attempt * n
        while not _bindable(host, port) and port < 65535 - n:
            port += n
    return [f"{host}:{port + i}" for i in range(n)]


def launch(script, script_args=(), nproc_per_node=1, host="127.0.0.1",
           start_port=6170, elastic_retries=0):
    """Start one process per rank and watch them. A rank that fails
    reaps the others; with ``elastic_retries > 0`` the whole job starts
    again, up to that many times, and the trainers resume from their
    auto-checkpoint (``incubate/checkpoint.py``)."""
    cards = _card_count()
    attempt = 0
    while True:
        endpoints = _endpoints(host, start_port, nproc_per_node, attempt)
        procs = [subprocess.Popen([sys.executable, script, *script_args],
                                  env=_build_env(rank, nproc_per_node,
                                                 endpoints, attempt, cards))
                 for rank in range(nproc_per_node)]
        failed_ret = None
        try:
            while procs:
                for p in list(procs):
                    ret = p.poll()
                    if ret is None:
                        continue
                    procs.remove(p)
                    if ret != 0:
                        # a sibling blocked in a collective with the dead
                        # rank must not hang the teardown: TERM, bounded
                        # wait, KILL
                        _reap(procs)
                        procs.clear()
                        failed_ret = ret
                        break
                time.sleep(0.5)
        except KeyboardInterrupt:
            _reap(procs)
            raise
        if failed_ret is None:
            return 0
        attempt += 1
        if attempt > elastic_retries:
            raise SystemExit(failed_ret)
        print(f"[paddle_tpu_torch.launch] job failed (rc={failed_ret}); "
              f"elastic restart {attempt}/{elastic_retries}", flush=True)


def launch_elastic(script, script_args=(), nproc_per_node=1,
                   host="127.0.0.1", start_port=6170, heartbeat_dir=None,
                   max_restarts=None, stall_timeout_s=None,
                   heartbeat_timeout_s=None, backoff_s=None, group=None):
    """Detection-driven elastic launch (``--elastic``): an
    ``elastic.Supervisor`` watches each trainer's exit status and its
    heartbeat file (``$PADDLE_ELASTIC_HEARTBEAT_DIR``) and restarts on
    death, silence or a stalled step. ``group`` (default: more than one
    rank) restarts the process group whole at a new rendezvous; a
    one-rank job restarts its one trainer."""
    heartbeat_dir = heartbeat_dir or os.environ.get(
        "PADDLE_ELASTIC_HEARTBEAT_DIR")
    if group is None:
        group = nproc_per_node > 1
    cards = _card_count()
    state = {"attempt": -1, "endpoints": None}

    def start_rank(rank):
        # a group incarnation starts with rank 0: it takes the new
        # rendezvous; a single rank's restart keeps the job's endpoints
        if state["endpoints"] is None or (group and rank == 0):
            state["attempt"] += 1
            state["endpoints"] = _endpoints(host, start_port,
                                            nproc_per_node,
                                            state["attempt"])
        env = _build_env(rank, nproc_per_node, state["endpoints"],
                         state["attempt"], cards)
        if heartbeat_dir:
            env["PADDLE_ELASTIC_HEARTBEAT_DIR"] = heartbeat_dir
        return subprocess.Popen([sys.executable, script, *script_args],
                                env=env)

    return Supervisor(start_rank, nranks=nproc_per_node,
                      heartbeat_dir=heartbeat_dir,
                      max_restarts=max_restarts,
                      stall_timeout_s=stall_timeout_s,
                      heartbeat_timeout_s=heartbeat_timeout_s,
                      backoff_s=backoff_s, group=group).run()


def launch_ps(script, script_args=(), server_num=1, worker_num=2,
              host="127.0.0.1", start_port=6270, elastic_retries=0):
    """Parameter-server launcher: server processes
    (``TRAINING_ROLE=PSERVER``) and worker processes
    (``TRAINING_ROLE=TRAINER``) with ``PADDLE_PSERVERS_IP_PORT_LIST``.
    The job succeeds when every worker exits 0 (the servers are then
    reaped); a failure restarts servers and workers up to
    ``elastic_retries`` times, and the scripts recover table state with
    ``PSClient.load_snapshot``."""
    eps = [f"{host}:{start_port + i}" for i in range(server_num)]

    def start_all(attempt):
        base = dict(os.environ)
        base["PADDLE_PSERVERS_IP_PORT_LIST"] = ",".join(eps)
        base["PADDLE_TRAINERS_NUM"] = str(worker_num)
        base["PADDLE_LAUNCH_ATTEMPT"] = str(attempt)
        servers = []
        for i in range(server_num):
            env = dict(base)
            env.update({"TRAINING_ROLE": "PSERVER",
                        "PADDLE_PSERVER_ID": str(i),
                        "PADDLE_PORT": eps[i].rsplit(":", 1)[1]})
            servers.append(subprocess.Popen(
                [sys.executable, script, *script_args], env=env))
        workers = []
        for i in range(worker_num):
            env = dict(base)
            env.update({"TRAINING_ROLE": "TRAINER",
                        "PADDLE_TRAINER_ID": str(i)})
            workers.append(subprocess.Popen(
                [sys.executable, script, *script_args], env=env))
        return servers, workers

    attempt = 0
    while True:
        servers, workers = start_all(attempt)
        failed_ret = None
        live = list(workers)
        try:
            while live and failed_ret is None:
                for p in list(live):
                    ret = p.poll()
                    if ret is None:
                        continue
                    live.remove(p)
                    if ret != 0:
                        failed_ret = ret
                for s in servers:          # a dead server fails the job
                    ret = s.poll()
                    if ret is not None and ret != 0 and failed_ret is None:
                        failed_ret = ret
                time.sleep(0.3)
        finally:
            _reap(live + servers, grace_s=30.0)
        if failed_ret is None:
            return 0
        attempt += 1
        if attempt > elastic_retries:
            raise SystemExit(failed_ret)
        print(f"[paddle_tpu_torch.launch] ps job failed (rc={failed_ret}); "
              f"elastic restart {attempt}/{elastic_retries}", flush=True)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    ap.add_argument("--nproc_per_node", type=int, default=1)
    ap.add_argument("--started_port", type=int, default=6170)
    ap.add_argument("--elastic_retries", type=int, default=0)
    ap.add_argument("--elastic", action="store_true",
                    help="supervisor-driven restart (heartbeat and stall "
                         "detection, PADDLE_ELASTIC_* knobs) instead of "
                         "the whole-job elastic_retries loop")
    ap.add_argument("--heartbeat_dir", default=None,
                    help="heartbeat directory for --elastic "
                         "(default $PADDLE_ELASTIC_HEARTBEAT_DIR)")
    ap.add_argument("--server_num", type=int, default=0)
    ap.add_argument("--worker_num", type=int, default=0)
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.server_num or args.worker_num:
        return launch_ps(args.script, args.script_args,
                         server_num=max(args.server_num, 1),
                         worker_num=max(args.worker_num, 1),
                         start_port=args.started_port,
                         elastic_retries=args.elastic_retries)
    if args.elastic:
        return launch_elastic(args.script, args.script_args,
                              args.nproc_per_node,
                              start_port=args.started_port,
                              heartbeat_dir=args.heartbeat_dir)
    return launch(args.script, args.script_args, args.nproc_per_node,
                  start_port=args.started_port,
                  elastic_retries=args.elastic_retries)


if __name__ == "__main__":
    sys.exit(main())
