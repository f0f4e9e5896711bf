"""paddle_tpu_torch.testing — deterministic test harnesses
(paddle_tpu/testing).

``faults`` scripts seeded fault injection at the boundaries that consult
``distributed/ps/rpc._fault``: the serve loop's scheduler beat here, the
PS transport and the streaming dataset once item 8 ports them.
"""
from . import faults

__all__ = ["faults"]
