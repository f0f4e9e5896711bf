"""Port parity: the conv and pooling layers (paddle_tpu_torch/nn/layer/
conv.py, pooling.py) and common.py's layers over the conv ops (Upsample*,
PixelShuffle, Unfold, RowConv). Each layer is built in both packages, the
JAX layer's parameters copied into the port's by module path
(``bridge.load_jax_params``), and the outputs, input gradients and
parameter gradients compared within 1e-5 (f32); the 13 pooling classes
and the layers without parameters, forward and input gradients. Then the
NHWC reference quirk of the conv layers."""
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


X1 = C.f32(2, 4, 11, seed=1)
X2 = C.f32(2, 4, 9, 9, seed=2)
X3 = C.f32(1, 4, 5, 6, 7, seed=3)
X8 = C.f32(2, 4, 8, 8, seed=4)

CONV_LAYERS = {
    "Conv1D": ((4, 6, 3), {"padding": 1}, X1),
    "Conv1D-same": ((4, 6, 3), {"stride": 2, "padding": "SAME"}, X1),
    "Conv2D": ((4, 6, 3), {"padding": 1}, X2),
    "Conv2D-pads4_s2": ((4, 6, 3), {"stride": 2, "padding": [1, 2, 0, 1]},
                        X2),
    "Conv2D-groups_dilated": ((4, 8, 3), {"padding": 2, "dilation": 2,
                                          "groups": 2}, X2),
    "Conv2D-depthwise_nobias": ((4, 4, 3), {"padding": 1, "groups": 4,
                                            "bias_attr": False}, X2),
    "Conv3D": ((4, 3, 3), {"padding": 1, "stride": 2}, X3),
    "Conv1DTranspose": ((4, 3, 3), {"stride": 2, "padding": 1,
                                    "output_padding": 1}, X1),
    "Conv2DTranspose": ((4, 3, 3), {"stride": 2, "padding": 1,
                                    "output_padding": 1}, X2),
    "Conv2DTranspose-groups": ((4, 6, 3), {"stride": 2, "groups": 2}, X2),
    "Conv3DTranspose": ((4, 2, 3), {"stride": 2, "padding": 1}, X3),
}


@pytest.mark.parametrize("name", sorted(CONV_LAYERS))
def test_conv_layer_matches_jax(name):
    args, kw, x = CONV_LAYERS[name]
    cls = name.split("-")[0]
    C.check(lambda pkg: getattr(pkg.nn, cls)(*args, **kw), [x])


POOL_LAYERS = {
    "MaxPool1D": ((3,), {"stride": 2, "padding": 1}, X1),
    "MaxPool2D": ((3,), {"stride": 2, "padding": 1}, X2),
    "MaxPool2D-ceil": ((2,), {"stride": 2, "ceil_mode": True}, X2),
    "AvgPool1D": ((3,), {"stride": 2, "padding": 1}, X1),
    "AvgPool2D": ((3,), {"stride": 2, "padding": 1}, X2),
    "AvgPool2D-inclusive_ceil": ((2,), {"stride": 2, "ceil_mode": True,
                                        "exclusive": False}, X2),
    "AvgPool3D": ((2,), {"stride": 2, "padding": 1}, X3),
    "MaxPool3D": ((2,), {"stride": 2}, X3),
    "AdaptiveAvgPool1D": ((4,), {}, C.f32(2, 4, 12, seed=5)),
    "AdaptiveMaxPool1D": ((4,), {}, C.f32(2, 4, 12, seed=5)),
    "AdaptiveAvgPool2D": ((1,), {}, C.f32(2, 4, 7, 7, seed=6)),
    "AdaptiveAvgPool2D-integral": (((4, 5),), {}, X2),
    "AdaptiveMaxPool2D": (((2, 4),), {}, X8),
    "AdaptiveAvgPool3D": ((1,), {}, X3),
    "AdaptiveMaxPool3D": (((1, 2, 7),), {}, C.f32(1, 4, 5, 6, 7, seed=7)),
    "Pool2D-max": ((), {"pool_size": 3, "pool_stride": 2,
                        "pool_padding": 1}, X2),
    "Pool2D-avg": ((), {"pool_size": 2, "pool_type": "avg",
                        "pool_stride": 2, "ceil_mode": True}, X2),
    "Pool2D-global": ((), {"pool_type": "avg", "global_pooling": True}, X2),
}


@pytest.mark.parametrize("name", sorted(POOL_LAYERS))
def test_pool_layer_matches_jax(name):
    args, kw, x = POOL_LAYERS[name]
    cls = name.split("-")[0]
    C.check(lambda pkg: getattr(pkg.nn, cls)(*args, **kw), [x])


def test_every_jax_conv_and_pool_layer_is_ported():
    import paddle_tpu.nn.layer.conv as jconv
    import paddle_tpu.nn.layer.pooling as jpool

    import paddle_tpu_torch.nn.layer.conv as tconv
    import paddle_tpu_torch.nn.layer.pooling as tpool
    assert tconv.__all__ == jconv.__all__
    assert tpool.__all__ == jpool.__all__
    assert len(tpool.__all__) == 13
    assert {n.split("-")[0] for n in CONV_LAYERS} == set(jconv.__all__)
    assert {n.split("-")[0] for n in POOL_LAYERS} == set(jpool.__all__)


COMMON = {
    "Upsample-nearest": (lambda p: p.nn.Upsample(scale_factor=2), X2),
    "Upsample-bilinear_down": (lambda p: p.nn.Upsample(
        size=[4, 6], mode="bilinear"), X2),
    "Upsample-bicubic": (lambda p: p.nn.Upsample(size=[12, 13],
                                                 mode="bicubic"), X2),
    "UpsamplingBilinear2D": (lambda p: p.nn.UpsamplingBilinear2D(
        size=[13, 17]), X2),
    "UpsamplingNearest2D": (lambda p: p.nn.UpsamplingNearest2D(
        size=[5, 13]), X2),
    "PixelShuffle": (lambda p: p.nn.PixelShuffle(2), X8),
    "Unfold": (lambda p: p.nn.Unfold(3, strides=2, paddings=1), X2),
    "RowConv": (lambda p: p.nn.RowConv(4, 2), C.f32(2, 7, 4, seed=8)),
}


@pytest.mark.parametrize("name", sorted(COMMON))
def test_common_conv_layer_matches_jax(name):
    make, x = COMMON[name]
    C.check(make, [x])


def test_conv_bn_relu_block_matches_jax_in_train_and_eval():
    """Conv2D -> BatchNorm2D -> ReLU -> MaxPool2D, ResNet's stem at a small
    width: outputs and gradients in train mode, the BN running stats
    after it (biased variance, momentum 0.9), then eval mode."""
    def make(pkg):
        nn = pkg.nn
        return nn.Sequential(nn.Conv2D(3, 8, 7, stride=2, padding=3,
                                       bias_attr=False),
                             nn.BatchNorm2D(8), nn.ReLU(),
                             nn.MaxPool2D(3, stride=2, padding=1))
    x = C.f32(2, 3, 32, 32, seed=9)
    jl, tl = C.check(make, [x], train=True)
    jb = dict(jl.functional_state()[1])
    for name, b in tl.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jb[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    jo, _, _ = C.run(jp, jl, [x], train=False, grad=False)
    to, _, _ = C.run(tp, tl, [x], train=False, grad=False)
    np.testing.assert_allclose(to[0], jo[0], rtol=1e-5, atol=1e-5)


def test_quirk_nhwc_conv2d_layer_reads_its_oihw_weight_as_hwio():
    """The conv layers always create OIHW weights, and ``conv2d`` under
    NHWC reads HWIO (XLA's dimension numbers): JAX's
    ``Conv2D(3, 8, 3, data_format="NHWC")`` convolves with an 8x3 kernel
    from 3 to 3 channels and then fails to add its 8 biases (TypeError
    "add got incompatible shapes"); the port does the same and raises
    torch's RuntimeError. Without a bias both give that conv's output."""
    x = C.f32(2, 10, 6, 3, seed=10)
    for pkg, err in ((jp, TypeError), (tp, RuntimeError)):
        layer = pkg.nn.Conv2D(3, 8, 3, data_format="NHWC")
        with pytest.raises(err):
            layer(pkg.to_tensor(x))
    jo, to = C.check(lambda pkg: pkg.nn.Conv2D(3, 8, 3, data_format="NHWC",
                                               bias_attr=False), [x])
    assert tuple(to(tp.to_tensor(x)).shape) == (2, 3, 4, 3)
