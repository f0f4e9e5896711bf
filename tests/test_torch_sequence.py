"""Port parity: core/ragged.py's RaggedTensor and ops/sequence.py's 18
ops against the JAX package's on the same seeded ragged batches.

A ragged result is held by its values and its row_splits, a dense one by
its values; integer outputs exactly, float ones at rtol 1e-6 / atol 1e-7
(segment sums in another order), gradients through the port's ops (the
JAX ops take raw arrays, so their gradients come from ``jax.grad`` of
the same function) at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core.ragged import RaggedTensor as JR
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.ragged import RaggedTensor as TR

JS, TS = jp.ops.sequence, tp.ops.sequence
TOL = dict(rtol=1e-6, atol=1e-7)

SPLITS = np.array([0, 3, 3, 7, 8], np.int32)      # lengths 3, 0, 4, 1
VALS = np.random.RandomState(0).uniform(-1, 1, (8, 3)).astype(np.float32)
IDS = np.random.RandomState(1).randint(0, 6, 8).astype(np.int64)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _np(x):
    if isinstance(x, (JR, TR)):
        return (_np(x.values), np.asarray(_np(x.row_splits)))
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _same(j, t):
    j, t = _np(j), _np(t)
    if isinstance(j, tuple):
        _same(j[0], t[0])
        np.testing.assert_array_equal(t[1], j[1])
        return
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, **TOL)
    else:
        np.testing.assert_array_equal(t, j)


def test_ragged_tensor_forms_and_accessors():
    rows = [VALS[0:3], VALS[3:3], VALS[3:7], VALS[7:8]]
    j = JR.from_rows([jnp.asarray(r) for r in rows])
    t = TR.from_rows([torch.from_numpy(r) for r in rows])
    _same(j, t)
    assert t.lod == j.lod and t.nrows == j.nrows == 4
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    _same(j.lengths, t.lengths)
    _same(j.segment_ids(), t.segment_ids().to(torch.int32))
    _same(j.to_padded(), t.to_padded())
    _same(j.to_padded(maxlen=5, pad_value=-2.0),
          t.to_padded(maxlen=5, pad_value=-2.0))
    back = TR.from_padded(t.to_padded(), t.lengths)
    _same(j, back)
    for a, b in zip(j.to_list(), t.to_list()):
        _same(a, b)


def _r(cls, vals=VALS, splits=SPLITS):
    if cls is JR:
        return JR(jnp.asarray(vals), splits)
    return TR(torch.from_numpy(vals), splits)


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "min",
                                  "first", "last"])
def test_sequence_pool(pool):
    _same(JS.sequence_pool(_r(JR), pool), TS.sequence_pool(_r(TR), pool))


@pytest.mark.parametrize("name, args", [
    ("sequence_softmax", ()),
    ("sequence_reverse", ()),
    ("sequence_first_step", ()),
    ("sequence_last_step", ()),
    ("sequence_pad", ()),
    ("sequence_pad", (1.5, 6)),
    ("sequence_slice", (np.array([1, 0, 2, 0]), np.array([2, 0, 2, 1]))),
    ("sequence_reshape", (6,)),
    ("sequence_topk_avg_pooling", ([1, 2, 5],)),
    ("sequence_topk_avg_pooling", ([2],)),
])
def test_sequence_op_on_packed_rows(name, args):
    # sequence_reshape needs each row's payload to divide the new width
    splits = np.array([0, 2, 2, 6, 8], np.int32) \
        if name == "sequence_reshape" else SPLITS
    j = getattr(JS, name)(_r(JR, VALS, splits), *args)
    t = getattr(TS, name)(_r(TR, VALS, splits), *args)
    for a, b in zip(j if isinstance(j, tuple) else (j,),
                    t if isinstance(t, tuple) else (t,)):
        _same(a, b)


def test_sequence_ops_over_ids():
    jr, tr_ = JR(jnp.asarray(IDS), SPLITS), TR(torch.from_numpy(IDS), SPLITS)
    _same(JS.sequence_enumerate(jr, 3, pad_value=-1),
          TS.sequence_enumerate(tr_, 3, pad_value=-1))
    _same(JS.sequence_erase(jr, [0, 3]), TS.sequence_erase(tr_, [0, 3]))
    _same(JS.sequence_mask(jnp.asarray([3, 0, 4, 1])),
          TS.sequence_mask(torch.tensor([3, 0, 4, 1])))
    _same(JS.sequence_mask(jnp.asarray([3, 0, 4, 1]), maxlen=6,
                           dtype="float32"),
          TS.sequence_mask(torch.tensor([3, 0, 4, 1]), maxlen=6,
                           dtype="float32"))


def test_sequence_expand_concat_unpad_scatter_conv():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    _same(JS.sequence_expand(jnp.asarray(x), _r(JR)),
          TS.sequence_expand(torch.from_numpy(x), _r(TR)))
    _same(JS.sequence_expand_as(jnp.asarray(x), _r(JR)),
          TS.sequence_expand_as(torch.from_numpy(x), _r(TR)))
    _same(JS.sequence_concat([_r(JR), _r(JR, VALS * 2)]),
          TS.sequence_concat([_r(TR), _r(TR, VALS * 2)]))
    padded = np.random.RandomState(2).randn(4, 5, 3).astype(np.float32)
    lens = np.array([3, 0, 4, 1])
    _same(JS.sequence_unpad(jnp.asarray(padded), lens),
          TS.sequence_unpad(torch.from_numpy(padded), lens))
    dense = np.zeros((4, 6), np.float32)
    pos = np.array([0, 2, 2, 1, 5, 0, 3, 4], np.int64)
    upd = np.random.RandomState(3).randn(8).astype(np.float32)
    _same(JS.sequence_scatter(jnp.asarray(dense), JR(jnp.asarray(pos),
                                                     SPLITS),
                              JR(jnp.asarray(upd), SPLITS)),
          TS.sequence_scatter(torch.from_numpy(dense),
                              TR(torch.from_numpy(pos), SPLITS),
                              TR(torch.from_numpy(upd), SPLITS)))
    w = np.random.RandomState(4).randn(9, 2).astype(np.float32)
    b = np.random.RandomState(5).randn(2).astype(np.float32)
    _same(JS.sequence_conv(_r(JR), jnp.asarray(w), 3, bias=jnp.asarray(b)),
          TS.sequence_conv(_r(TR), torch.from_numpy(w), 3,
                           bias=torch.from_numpy(b)))
    _same(JS.sequence_conv(_r(JR), jnp.asarray(w[:6]), 2, context_start=0),
          TS.sequence_conv(_r(TR), torch.from_numpy(w[:6]), 2,
                           context_start=0))


@pytest.mark.parametrize("name", ["sequence_pool_max", "sequence_softmax",
                                  "sequence_conv", "sequence_pool_average"])
def test_sequence_gradients_match_jax(name):
    w = np.random.RandomState(6).randn(9, 2).astype(np.float32)
    ct_shape = {"sequence_pool_max": (4, 3), "sequence_pool_average": (4, 3),
                "sequence_softmax": (8, 3), "sequence_conv": (8, 2)}[name]
    ct = np.random.RandomState(7).randn(*ct_shape).astype(np.float32)

    def run(S, R, v, wt):
        if name.startswith("sequence_pool"):
            out = S.sequence_pool(R(v, SPLITS), name.rsplit("_", 1)[1])
        elif name == "sequence_softmax":
            out = S.sequence_softmax(R(v, SPLITS)).values
        else:
            out = S.sequence_conv(R(v, SPLITS), wt, 3).values
        return out

    # the empty row pools to -inf (max) / 0 (average): no cotangent there
    ct[1] = 0.0
    jg = jax.grad(lambda v, wt: jnp.sum(jnp.where(
        jnp.isfinite(o := run(JS, JR, v, wt)), o, 0) * ct),
        argnums=(0, 1))(jnp.asarray(VALS), jnp.asarray(w))
    v = torch.from_numpy(VALS.copy()).requires_grad_()
    wt = torch.from_numpy(w.copy()).requires_grad_()
    o = run(TS, TR, v, wt)
    torch.sum(torch.where(torch.isfinite(o), o, 0) * torch.from_numpy(ct)) \
        .backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[0]), **TOL)
    if name == "sequence_conv":
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg[1]),
                                   rtol=1e-5, atol=1e-6)


def test_registered_plain_as_jax():
    for n in JS.__all__:
        assert n in tp.ops.OP_REGISTRY
        assert getattr(tp.ops.OP_REGISTRY[n], "op_version", None) is None
