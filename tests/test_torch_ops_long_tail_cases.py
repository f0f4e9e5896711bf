"""The long-tail sweep groups (``paddle_tpu_torch/testing/long_tail_cases.py``,
JAX-free so that chip_smoke.py can run them on the card) as the parity
tests import them, with both packages' ``quantization`` imported: each
registers ``fake_quant``, whose cases are in ``MATH_EXTRA``. No test here.
"""
import paddle_tpu.quantization  # noqa: F401
import paddle_tpu_torch.quantization  # noqa: F401
from paddle_tpu_torch.testing.long_tail_cases import *  # noqa: F401,F403
from paddle_tpu_torch.testing.long_tail_cases import (  # noqa: F401
    GROUPS, OWN_TESTS)
