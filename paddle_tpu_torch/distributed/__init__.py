"""paddle.distributed (paddle_tpu/distributed) over torch.distributed.

The collective tier: the PADDLE_* env contract (``env.py``,
``bootstrap.py``, ``spawn.py``), named meshes over the world's ranks with
``shard_map`` (``mesh.py``), collectives (``collective.py``), ring and
Ulysses attention with their backward (``ring_attention.py``), the
tensor-parallel rule tables and ZeRO's specs (``sharding.py``),
``DataParallel`` (``parallel.py``), the pipeline schedules
(``pipeline.py``), MoE (``moe.py``), LocalSGD (``localsgd.py``), fleet's
``init`` / strategy / ``distributed_optimizer`` and the Megatron layers
(``fleet/``) and ``recompute``. The parameter-server tier is ``ps/``. The
launcher and elastic training wait for ROADMAP Queue 1 item 7c: their
names raise ``NotImplementedError``.
"""
import importlib as _importlib

from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from . import mesh  # noqa: F401
from .mesh import (get_mesh, init_hybrid_mesh, init_mesh,  # noqa: F401
                   in_spmd_region, mesh_axis_size, reset_mesh, shard_map)

_LAZY_MODULES = ("fleet", "sharding", "pipeline", "spawn", "moe",
                 "collective", "parallel", "ring_attention", "bootstrap",
                 "ps", "localsgd", "recompute")
_LAZY_NAMES = {
    "recompute": "recompute", "checkpoint_policy": "recompute",
    "all_gather": "collective", "all_reduce": "collective",
    "alltoall": "collective", "barrier": "collective",
    "broadcast": "collective", "recv": "collective", "reduce": "collective",
    "reduce_scatter": "collective", "scatter": "collective",
    "hierarchical_all_reduce": "collective", "p2p_permute": "collective",
    "send": "collective", "ReduceOp": "collective", "split": "collective",
    "new_group": "collective", "wait": "collective",
    "all_gather_object": "collective",
    "DataParallel": "parallel", "init_parallel_env": "parallel",
    "ring_attention_fn": "ring_attention",
}
# item 7c: modules not ported yet
_ITEM_7C = ("launch", "elastic")


def __getattr__(name):
    if name in ("InMemoryDataset", "QueueDataset", "DatasetFactory"):
        from ..io import fleet_dataset as _fd
        val = globals()[name] = getattr(_fd, name)
        return val
    if name in _ITEM_7C:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.{name} waits for ROADMAP Queue 1 "
            "item 7c")
    if name in _LAZY_MODULES and name not in _LAZY_NAMES:
        mod = _importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in _LAZY_NAMES:
        mod = _importlib.import_module(f".{_LAZY_NAMES[name]}", __name__)
        # a function sharing its module's name (recompute) must win over
        # the submodule binding the import left on the package
        for n, m in _LAZY_NAMES.items():
            if m == _LAZY_NAMES[name]:
                globals()[n] = getattr(
                    mod, n if n != "ring_attention_fn" else "ring_attention")
        return globals()[name]
    raise AttributeError(
        f"module 'paddle_tpu_torch.distributed' has no attribute {name!r}")
