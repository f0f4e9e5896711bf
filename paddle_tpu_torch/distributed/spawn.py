"""paddle.distributed.spawn (paddle_tpu/distributed/spawn.py): start
``nprocs`` worker processes running ``func(*args)`` with the PADDLE_* env
(rank, world size, endpoints on free localhost ports, all of them on this
node), through ``torch.multiprocessing``'s spawn context. The workers
join the group with ``init_parallel_env()``
(``bootstrap.maybe_initialize_distributed``)."""
from __future__ import annotations

import os
import socket

import torch.multiprocessing as mp

__all__ = ["spawn"]


def _free_ports(n):
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _worker(rank, nprocs, endpoints, init_method, func, args):
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    os.environ["PADDLE_TRAINER_ENDPOINTS"] = ",".join(endpoints)
    os.environ["PADDLE_CURRENT_ENDPOINT"] = endpoints[rank]
    os.environ["PADDLE_LOCAL_SIZE"] = str(nprocs)
    os.environ["PADDLE_LOCAL_RANK"] = str(rank)
    if init_method:
        os.environ["PADDLE_DIST_INIT_METHOD"] = init_method
    func(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    """``options``: ``init_method``, the workers' rendezvous in place of
    rank 0's endpoint (``file://<path>``: a FileStore, no port)."""
    ctx = mp.get_context("spawn")
    endpoints = [f"127.0.0.1:{p}" for p in _free_ports(nprocs)]
    init_method = options.get("init_method")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(rank, nprocs, endpoints, init_method, func,
                              args),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"spawned workers failed with codes {bad}")
    return procs
