"""The distributed environment contract (paddle_tpu/distributed/env.py):
rank and world size from the ``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM`` variables that the reference's launcher sets.

Where a variable is absent, the JAX package asks jax for the process
index and count; the port asks ``torch.distributed`` where a process
group is up, else it is rank 0 of 1."""
from __future__ import annotations

import os

__all__ = ["get_rank", "get_world_size"]


def _group_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    v = os.environ.get("PADDLE_TRAINER_ID")
    if v is not None:
        return int(v)
    if _group_up():
        import torch.distributed as dist
        return dist.get_rank()
    return 0


def get_world_size() -> int:
    v = os.environ.get("PADDLE_TRAINERS_NUM")
    if v is not None:
        return int(v)
    if _group_up():
        import torch.distributed as dist
        return dist.get_world_size()
    return 1
