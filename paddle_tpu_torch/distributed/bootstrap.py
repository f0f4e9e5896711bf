"""Multi-process bootstrap: the PADDLE_* env contract ->
``torch.distributed.init_process_group``
(paddle_tpu/distributed/bootstrap.py).

``PADDLE_TRAINER_ID`` is the rank, ``PADDLE_TRAINERS_NUM`` the world size,
``PADDLE_TRAINER_ENDPOINTS[0]`` the rendezvous (rank 0's endpoint, as the
reference's NCCL-id TCP server is) unless ``PADDLE_DIST_INIT_METHOD``
names another torch.distributed init method (``file://<path>``: a
FileStore, which needs no port). The backend is ``nccl`` when each rank
of the node has a card of its own, ``gloo`` on the CPU and when ranks
share a card (NCCL refuses two ranks on one device). The ranks of the
node are ``PADDLE_LOCAL_SIZE`` / ``PADDLE_LOCAL_RANK`` when set, else the
endpoints on this rank's host.
"""
from __future__ import annotations

import datetime
import os

__all__ = ["maybe_initialize_distributed", "is_initialized",
           "default_backend", "local_ranks"]

_initialized = False


def is_initialized() -> bool:
    return _initialized


def local_ranks(rank: int, n: int, endpoints=()):
    """(ranks on this node, this rank's index among them)."""
    if os.environ.get("PADDLE_LOCAL_SIZE"):
        size = int(os.environ["PADDLE_LOCAL_SIZE"])
        return size, int(os.environ.get("PADDLE_LOCAL_RANK", rank % size))
    if endpoints:
        host = endpoints[rank].rsplit(":", 1)[0]
        mine = [i for i, e in enumerate(endpoints)
                if e.rsplit(":", 1)[0] == host]
        return len(mine), mine.index(rank)
    return n, rank


def default_backend(local_size: int) -> str:
    """``nccl`` when the node's ``local_size`` ranks each have a card."""
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_size:
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(timeout_s: int = 120) -> bool:
    """Join the process group when the PADDLE_* contract declares more
    than one trainer. Idempotent; one-process jobs (or a group already
    up) are a no-op. True if this call (or an earlier one, or the caller)
    brought the group up."""
    global _initialized
    import torch.distributed as dist
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    endpoints = [e for e in os.environ.get(
        "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
    init_method = os.environ.get("PADDLE_DIST_INIT_METHOD")
    if n <= 1 or not (endpoints or init_method):
        return False
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if endpoints and len(endpoints) != n:
        raise ValueError(
            f"PADDLE_TRAINER_ENDPOINTS has {len(endpoints)} entries but "
            f"PADDLE_TRAINERS_NUM={n}")
    local_size, local_rank = local_ranks(rank, n, endpoints)
    backend = default_backend(local_size)
    if backend == "nccl":
        import torch
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{endpoints[0]}",
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True
    return True
