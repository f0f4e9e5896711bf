"""paddle_tpu_torch.testing — deterministic test harnesses
(paddle_tpu/testing).

``faults`` scripts seeded fault injection at the boundaries that consult
``distributed/ps/rpc._fault``: the serve loop's scheduler beat, the PS
transport's frame boundaries and the streaming dataset's deliveries.
``spmd``, ``spmd_train`` and ``spmd_static`` hold the rank bodies of the
multi-process parity cases (imported where used); ``fit_job`` is the
data-parallel fit a launched job runs.
"""
from . import faults

__all__ = ["faults"]
