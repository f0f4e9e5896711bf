"""Port parity, op by op: the shape, indexing and rearrangement ops
(tests/test_torch_ops_cases.py holds the cases; each runs the JAX op and
the port's of the same registry name on the same seeded numpy inputs,
forward and gradients, within the case's tolerance, f32 rtol 1e-5 and
atol 1e-6 unless it says otherwise)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp

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


@pytest.mark.parametrize("case", P.MANIPULATION, ids=str)
def test_op_matches_jax(case):
    P.run(case)


@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_in_bf16_match_jax(largest):
    """bf16 values with ties (C2): the same indices as lax.top_k, lower
    index first, and the same values."""
    x = np.array([[0.5, 0.25, 0.5, 1.0, 0.25, 0.5, 1.0, 0.25]], np.float32)
    j = jp.topk(jp.cast(jp.to_tensor(x), "bfloat16"), 5, largest=largest)
    t = tp.topk(tp.cast(tp.to_tensor(x), "bfloat16"), 5, largest=largest)
    assert t[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1].numpy()))
    np.testing.assert_array_equal(t[0].float().numpy(),
                                  np.asarray(j[0].numpy()).astype(np.float32))
