"""Port parity: the detection ops' sweep cases (``DETECTION`` in
tests/test_torch_ops_long_tail_cases.py), the JAX op and the port's of
the same registry name on the same seeded inputs, forward and gradients.
"""
import pytest
import torch

import test_torch_ops_cases as P
import test_torch_ops_long_tail_cases as L
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


@pytest.mark.parametrize("case", L.DETECTION, ids=str)
def test_op_matches_jax(case):
    P.run(case)


def test_distribute_fpn_proposals_matches_jax():
    import numpy as np
    import paddle_tpu as jp
    import paddle_tpu_torch as tp
    rois = np.abs(P.f32(12, 4, seed=5)) * 300
    rois[:, 2:] += rois[:, :2] + 4
    (jl, jr), (tl, tr_) = [pkg.ops.distribute_fpn_proposals(
        pkg.to_tensor(rois.astype(np.float32)), 2, 5, 4, 224)
        for pkg in (jp, tp)]
    assert len(tl) == len(jl) == 4
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()))
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr.numpy()))
