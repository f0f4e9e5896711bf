"""Port parity: the top-level v1 names (paddle_tpu_torch/_legacy_api.py)
and ``get_all_devices``, against paddle_tpu's on the same inputs, exact
(f32 rtol 1e-6)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu._legacy_api as jlegacy
import paddle_tpu_torch as tp
import paddle_tpu_torch._legacy_api as tlegacy
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


A = np.arange(12, dtype=np.float32).reshape(3, 4) - 5.5
B = np.linspace(0.5, 3.0, 12, dtype=np.float32).reshape(3, 4)


def _both(fn):
    j, t = fn(jp), fn(tp)
    j = np.asarray(j.numpy()) if hasattr(j, "numpy") else j
    t = t.numpy() if hasattr(t, "numpy") else t
    return j, t


@pytest.mark.parametrize("fn", [
    lambda p: p.add_n([p.to_tensor(A), p.to_tensor(B), p.to_tensor(A)]),
    lambda p: p.mm(p.to_tensor(A), p.to_tensor(B.T.copy())),
    lambda p: p.numel(p.to_tensor(A)),
    lambda p: p.rank(p.to_tensor(A)),
    lambda p: p.shape(p.to_tensor(A)),
    lambda p: p.has_inf(p.to_tensor(np.array([1.0, np.inf], np.float32))),
    lambda p: p.has_nan(p.to_tensor(A)),
    lambda p: p.fill_constant([2, 3], "float32", 1.5),
    lambda p: p.fill_constant([2], "int32", 7),
    lambda p: p.floor_mod(p.to_tensor(A), p.to_tensor(B)),
    *[(lambda n: lambda p: getattr(p, n)(p.to_tensor(A), p.to_tensor(B)))(n)
      for n in ("elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div", "elementwise_mod",
                "elementwise_floordiv")],
    lambda p: p.elementwise_pow(p.to_tensor(B), p.to_tensor(A / 4)),
    *[(lambda n: lambda p: getattr(p, n)(p.to_tensor(B), dim=1,
                                         keep_dim=True))(n)
      for n in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                "reduce_prod")],
    lambda p: p.reduce_sum(p.to_tensor(A)),
    lambda p: p.create_global_var([2, 2], 3.0, "float32"),
], ids=["add_n", "mm", "numel", "rank", "shape", "has_inf", "has_nan",
        "fill_constant", "fill_constant_int", "floor_mod", "add", "sub",
        "mul", "div", "mod", "floordiv", "pow", "reduce_sum", "reduce_mean",
        "reduce_max", "reduce_min", "reduce_prod", "reduce_sum_all",
        "create_global_var"])
def test_legacy_function_matches_jax(fn):
    j, t = _both(fn)
    assert np.asarray(t).shape == np.asarray(j).shape
    assert np.asarray(t).dtype == np.asarray(j).dtype
    np.testing.assert_allclose(t, j, rtol=1e-6)


def test_legacy_helpers():
    assert tp.broadcast_shape([3, 1], [1, 4]) == \
        jp.broadcast_shape([3, 1], [1, 4]) == [3, 4]
    assert tp.is_tensor(tp.to_tensor(A)) and not tp.is_tensor(A)
    assert tp.VarBase is tp.Tensor and tp.LoDTensorArray is list
    assert tp.get_default_dtype() == jp.get_default_dtype() == "float32"
    try:
        assert tp.set_default_dtype(np.float64) == "float64"
        assert tp.get_default_dtype() == "float64"
    finally:
        tp.set_default_dtype("float32")
    assert tp.is_compiled_with_xpu() is False
    t = tp.to_tensor(A)
    assert tp.get_tensor_from_selected_rows(t) is t
    p = tp.create_parameter([3, 2], "float32")
    assert isinstance(p, tp.Parameter) and p.shape == (3, 2) \
        and not p.stop_gradient
    assert tp.create_parameter([2], "float32", is_bias=True).sum() == 0
    v = tp.get_cudnn_version()
    assert v is None or isinstance(v, int)
    before = np.get_printoptions()["precision"]
    tp.set_printoptions(precision=3)
    try:
        assert np.get_printoptions()["precision"] == 3
    finally:
        tp.set_printoptions(precision=before)


def test_every_legacy_name_is_ported_but_lod_tensor():
    """Every legacy name is ported; ``LoDTensor``, the last one, is the
    port's RaggedTensor as it is the JAX package's."""
    missing = [n for n in jlegacy.__all__ if not hasattr(tp, n)]
    assert missing == []
    assert set(tlegacy.__all__) == set(jlegacy.__all__)
    from paddle_tpu_torch.core.ragged import RaggedTensor
    assert tp.LoDTensor is RaggedTensor


def test_get_all_devices():
    devs = tdevice.get_all_devices()
    if torch.cuda.is_available():
        assert devs == [f"gpu:{i}" for i in range(torch.cuda.device_count())]
    else:
        assert devs == ["cpu"]
    from paddle_tpu import device as jdevice
    assert all(isinstance(d, str) for d in jdevice.get_all_devices())
