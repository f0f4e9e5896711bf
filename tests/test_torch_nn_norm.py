"""Port parity: the normalization layers (paddle_tpu_torch/nn/layer/
norm.py) against paddle_tpu's, forward, input and parameter gradients
within 1e-5 (f32; 1e-4 where a batch statistic sums 72 terms), and
BatchNorm's running statistics after three training steps (Paddle's
momentum convention, running = 0.9 * running + 0.1 * batch, the batch
variance biased as in the JAX op) within 1e-6."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_torch_nn_cases as C
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


NCHW = C.f32(2, 4, 3, 3, seed=1) + 0.5
NCL = C.f32(3, 4, 6, seed=2)
NCDHW = C.f32(2, 4, 2, 3, 3, seed=3)


@pytest.mark.parametrize("name, x", [
    ("BatchNorm", NCHW), ("BatchNorm1D", NCL), ("BatchNorm2D", NCHW),
    ("BatchNorm3D", NCDHW), ("SyncBatchNorm", NCHW)])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(name, x, train):
    C.check(lambda pkg: getattr(pkg.nn, name)(4), [x], train=train,
            rtol=1e-4, atol=1e-5)


def test_batch_norm_running_stats_after_three_steps():
    jp.seed(0)
    jbn = jp.nn.BatchNorm2D(4, momentum=0.8)
    tbn = C.copy_state(jbn, tp.nn.BatchNorm2D(4, momentum=0.8))
    for step in range(3):
        x = C.f32(2, 4, 3, 3, seed=10 + step, scale=1.0 + step) + step
        C.run(jp, jbn, [x], train=True, grad=False)
        C.run(tp, tbn, [x], train=True, grad=False)
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(
                getattr(tbn, name).numpy(),
                np.asarray(getattr(jbn, name).numpy()), atol=1e-6,
                err_msg=f"{name} after step {step}")
    # eval normalizes by the running statistics
    out, _, _ = C.run(tp, tbn, [NCHW], grad=False)
    jout, _, _ = C.run(jp, jbn, [NCHW], grad=False)
    np.testing.assert_allclose(out[0], jout[0], atol=1e-5)


def test_batch_norm_momentum_convention():
    """One step from zeros / ones: running = 0.9 * old + 0.1 * batch, the
    batch variance biased."""
    bn = tp.nn.BatchNorm1D(4)
    x = C.f32(6, 4, seed=5)
    bn.train()
    bn(tp.to_tensor(x))
    np.testing.assert_allclose(bn._mean.numpy(), 0.1 * x.mean(0),
                               atol=1e-6)
    np.testing.assert_allclose(bn._variance.numpy(),
                               0.9 + 0.1 * x.var(0), atol=1e-6)


def test_batch_norm_use_global_stats_and_channels_last():
    C.check(lambda pkg: pkg.nn.BatchNorm2D(4, use_global_stats=True),
            [NCHW], train=True)
    C.check(lambda pkg: pkg.nn.BatchNorm2D(3, data_format="NHWC"),
            [NCHW], train=True, rtol=1e-4)


def test_convert_sync_batchnorm_keeps_the_values():
    net = tp.nn.Sequential(tp.nn.Linear(4, 4), tp.nn.BatchNorm1D(4))
    net[1]._mean.fill_(0.5)
    out = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], tp.nn.SyncBatchNorm)
    np.testing.assert_array_equal(out[1]._mean.numpy(), np.full(4, 0.5))


@pytest.mark.parametrize("make, x", [
    (lambda pkg: pkg.nn.LayerNorm([3, 3]), NCHW),
    (lambda pkg: pkg.nn.RMSNorm(6), NCL),
    (lambda pkg: pkg.nn.GroupNorm(2, 4), NCHW),
    (lambda pkg: pkg.nn.InstanceNorm1D(4), NCL),
    (lambda pkg: pkg.nn.InstanceNorm2D(4), NCHW),
    (lambda pkg: pkg.nn.InstanceNorm3D(4), NCDHW),
    (lambda pkg: pkg.nn.InstanceNorm2D(4, weight_attr=False,
                                       bias_attr=False), NCHW),
    (lambda pkg: pkg.nn.LocalResponseNorm(3, alpha=0.1, k=2.0), NCHW),
], ids=["layer", "rms", "group", "instance1d", "instance2d", "instance3d",
        "instance_no_affine", "lrn"])
def test_norm_layer_matches_jax(make, x):
    C.check(make, [x], train=True, rtol=1e-4)
