"""Port parity, op by op: the convolution, pooling and resampling ops of
ops/conv.py (tests/test_torch_ops_cases.py's ``CONV`` holds the cases:
each runs the JAX op and the port's of the same registry name on the same
seeded numpy inputs, forward and gradients, f32 and, where the case says
so, bf16, within the case's stated tolerance), and the two host-random
ops, ``random_crop`` and ``shuffle_batch``, whose draws are numpy's in
both packages."""
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


@pytest.mark.parametrize("case", P.CONV, ids=str)
def test_op_matches_jax(case):
    P.run(case)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_crop_matches_jax(seed):
    x = P.f32(2, 3, 9, 8, seed=seed)
    j = jp.ops.OP_REGISTRY["random_crop"](jp.to_tensor(x), [5, 4], seed=seed)
    t = tp.ops.OP_REGISTRY["random_crop"](tp.to_tensor(x), [5, 4], seed=seed)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


@pytest.mark.parametrize("seed", [0, 5])
def test_shuffle_batch_matches_jax(seed):
    x = P.f32(7, 3, seed=seed)
    j = jp.ops.OP_REGISTRY["shuffle_batch"](jp.to_tensor(x), seed=seed)
    t = tp.ops.OP_REGISTRY["shuffle_batch"](tp.to_tensor(x), seed=seed)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


def test_quirk_jax_bf16_conv2d_has_no_gradient():
    """JAX 0.9's bf16 conv2d (the product in f32, then rounded) cannot be
    differentiated: its transpose rule meets an f32 cotangent with bf16
    weights and raises. The port's bf16 gradients are held to JAX's f32
    gradients on the same bf16-rounded inputs."""
    x, w, b = P.CX, P.CW, P.CB
    c = P.rs(100).uniform(-1, 1, (2, 6, 9, 9)).astype(np.float32)
    jx, jw = (jp.to_tensor(a, dtype="bfloat16", stop_gradient=False)
              for a in (x, w))
    jy = jp.ops.conv2d(jx, jw, jp.to_tensor(b, dtype="bfloat16"), padding=1)
    with pytest.raises(TypeError, match="same dtypes"):
        (jy * jp.to_tensor(c)).sum().backward()
    # JAX's f32 gradients of the bf16-rounded values
    rx, rw = (np.asarray(jp.cast(jp.to_tensor(a), "bfloat16")
                         .astype("float32").numpy()) for a in (x, w))
    fx, fw = (jp.to_tensor(a, stop_gradient=False) for a in (rx, rw))
    (jp.ops.conv2d(fx, fw, padding=1) * jp.to_tensor(c)).sum().backward()
    tx, tw = (tp.to_tensor(a, dtype="bfloat16", stop_gradient=False)
              for a in (x, w))
    ty = tp.ops.conv2d(tx, tw, tp.to_tensor(b, dtype="bfloat16"), padding=1)
    (ty * tp.to_tensor(c)).sum().backward()
    for got, want in ((tx.grad, fx.grad), (tw.grad, fw.grad)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.numpy()),
                                   rtol=2 ** -5, atol=2 ** -5)


@pytest.mark.parametrize("op", ["max_pool2d", "avg_pool2d"])
def test_quirk_jax_2d_pool_string_padding_raises(op):
    """JAX's 2-D pools raise TypeError for 'SAME' / 'VALID' (a list
    concatenated with the string); the 1-D and 3-D pools take them. The
    port's 2-D pools take them too and equal JAX's 3-D pool over a unit
    depth (XLA's SAME pads, never exclusive)."""
    x = P.CX8
    with pytest.raises(TypeError):
        jp.ops.OP_REGISTRY[op](jp.to_tensor(x), 3, stride=2, padding="SAME")
    j3 = jp.ops.OP_REGISTRY[op.replace("2d", "3d")](
        jp.to_tensor(x[:, :, None]), (1, 3, 3), stride=(1, 2, 2),
        padding="SAME")
    t = tp.ops.OP_REGISTRY[op](tp.to_tensor(x), 3, stride=2, padding="SAME")
    np.testing.assert_allclose(t.numpy(), np.asarray(j3.numpy())[:, :, 0],
                               rtol=1e-6, atol=1e-6)


def test_quirk_ceil_mode_window_of_padding_only():
    """At L 5, k 2, s 2, p 1 with ceil_mode JAX counts 4 windows, where
    torch's rule counts 3; the last is padding only: max gives -inf there
    and an exclusive average 0 / 0 = nan. The port keeps JAX's."""
    x = P.P5
    assert torch.nn.functional.max_pool2d(
        torch.from_numpy(x), 2, 2, 1, ceil_mode=True).shape[-1] == 3
    for op, edge in (("max_pool2d", -np.inf), ("avg_pool2d", np.nan)):
        j = np.asarray(jp.ops.OP_REGISTRY[op](
            jp.to_tensor(x), 2, stride=2, padding=1, ceil_mode=True).numpy())
        t = tp.ops.OP_REGISTRY[op](tp.to_tensor(x), 2, stride=2, padding=1,
                                   ceil_mode=True).numpy()
        assert j.shape[-2:] == t.shape[-2:] == (4, 4)
        np.testing.assert_array_equal(t[..., -1], j[..., -1])
        np.testing.assert_array_equal(t[..., -1], np.full_like(t[..., -1],
                                                               edge))


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_conv_oracle_holds_the_cpu_path():
    """chip_smoke.py phase 20(a)'s float64 oracle (written there, apart
    from the port) against the port's CPU path, f32 and bf16: every case
    within the limits the card is held to."""
    worst, rows = _chip_smoke().conv_oracle_errors("cpu")
    assert len(rows) == 2 * 23
    assert set(worst) == {"conv2d", "conv2d_transpose", "max_pool2d",
                          "avg_pool2d", "interpolate"}


def test_chip_smoke_conv_oracle_catches_the_planted_fault(monkeypatch):
    """The planted conv fault (XLA's SAME pads with the odd element on the
    low side) fails phase 20(a)'s oracle."""
    from paddle_tpu_torch.ops import conv
    smoke = _chip_smoke()
    name = "vision_same_pads_low_side"
    source, old, new = smoke.FAULTS[name]
    assert source == "paddle_tpu_torch/ops/conv.py" and old.strip() in \
        open(conv.__file__).read()

    def low_side(spatial, window, strides):
        pads = []
        for size, k, s in zip(spatial, window, strides):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads.append((total - total // 2, total // 2))
        return pads

    monkeypatch.setattr(conv, "_same_pads", low_side)
    with pytest.raises(RuntimeError, match="same_s2"):
        smoke.conv_oracle_errors("cpu", dtypes=(torch.float32,))


@pytest.mark.parametrize("op, size, err", [
    ("adaptive_max_pool2d", [4, 5], NotImplementedError),
    ("adaptive_max_pool3d", [2, 4, 4], ValueError),
    ("adaptive_avg_pool3d", [2, 4, 4], ValueError)])
def test_non_divisible_adaptive_pools_raise_as_jax(op, size, err):
    """The adaptive max pools (and the 3-D average) take divisible sizes
    only, in both packages; the 2-D average takes the integral image."""
    x = P.CX if op.endswith("2d") else P.f32(1, 2, 5, 6, 7, seed=3)
    for pkg in (jp, tp):
        with pytest.raises(err):
            pkg.ops.OP_REGISTRY[op](pkg.to_tensor(x), size)


def test_bf16_conv_adds_its_bias_after_the_rounded_product():
    """JAX rounds a bf16 conv's f32 product to bf16 and then adds the bias
    in bf16: two roundings. The port does the same, and so differs from
    torch's fused ``F.conv2d(bias=...)`` (one rounding) on some entries."""
    x, w = (tp.to_tensor(a, dtype="bfloat16") for a in (P.CX, P.CW))
    b = tp.to_tensor(P.CB * 37.0, dtype="bfloat16")
    got = tp.ops.conv2d(x, w, b, padding=1)
    plain = tp.ops.conv2d(x, w, padding=1)
    assert torch.equal(got, (plain + b.reshape(1, -1, 1, 1)))
    fused = torch.nn.functional.conv2d(x.float(), w.float(), b.float(),
                                       padding=1).to(torch.bfloat16)
    assert not torch.equal(got, fused)
    j = jp.ops.conv2d(jp.to_tensor(P.CX, dtype="bfloat16"),
                      jp.to_tensor(P.CW, dtype="bfloat16"),
                      jp.to_tensor(P.CB * 37.0, dtype="bfloat16"), padding=1)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(j.astype("float32").numpy()),
                               rtol=2 ** -7, atol=2 ** -5)
