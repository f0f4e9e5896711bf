"""Port parity, op by op: the activation, normalization and loss ops, and
the attention and loss-head ops of nn/functional
(tests/test_torch_ops_cases.py holds the cases; each runs the JAX op and
the port's of the same registry name on the same seeded numpy inputs,
forward and gradients, within the case's tolerance, f32 rtol 1e-5 and
atol 1e-6 unless it says otherwise)."""
import pytest
import torch
import paddle_tpu as jp
import test_torch_ops_cases as P
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: one intra-op thread leaves the other cores to the
    timing-sensitive tests that run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def _kernels_in_interpret_mode():
    """The JAX package's flash and fused-CE kernels run in interpret mode
    on the CPU (their ops sit behind these flags)."""
    jp.set_flags({"FLAGS_pallas_interpret": True,
                  "FLAGS_flash_attention_interpret": True})
    yield
    jp.set_flags({"FLAGS_pallas_interpret": False,
                  "FLAGS_flash_attention_interpret": False})


@pytest.mark.parametrize("case", P.ACTIVATION + P.NORM + P.LOSS + P.HEAD
                         + P.RNN, ids=str)
def test_op_matches_jax(case):
    P.run(case)
