"""Port parity: ops/loss.py's recursions and sampled losses (``ctc_loss``
/ ``warpctc``, ``linear_chain_crf``, ``viterbi_decode``, ``center_loss``,
``nce``, ``hsigmoid_loss``): the sweep cases (``LOSS_TAIL`` in
tests/test_torch_ops_long_tail_cases.py, rtol 1e-4 / atol 1e-5 for the
recursions), and the rows where torch's own CTC would differ.

The CTC inputs hold an infeasible row (3 frames for 4 labels) and a row
with no label. JAX's log-space recursion gives the infeasible row a
finite loss near 1e30 and a finite gradient; the port's recursion
(``NEG = -1e30`` and ``_lse`` as ``jax.scipy.special.logsumexp``) gives
the same, where ``torch.nn.functional.ctc_loss`` gives inf.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_torch_ops_cases as P
import test_torch_ops_long_tail_cases as L
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


@pytest.mark.parametrize("case", L.LOSS_TAIL, ids=str)
def test_op_matches_jax(case):
    P.run(case)


def _ctc(pkg):
    x = pkg.to_tensor(L.CTC_LOGITS, stop_gradient=False)
    loss = pkg.ops.ctc_loss(x, pkg.to_tensor(L.CTC_LABELS),
                            pkg.to_tensor(L.CTC_IN), pkg.to_tensor(L.CTC_LAB),
                            reduction="none")
    loss.sum().backward()
    return np.asarray(loss.numpy()), np.asarray(x.grad.numpy())


def test_infeasible_and_empty_rows_are_jax_numbers_not_torch_inf():
    (jl, jg), (tl, tg) = _ctc(jp), _ctc(tp)
    # row 2: 3 frames cannot emit 4 labels: finite, near 1e30, in both
    assert np.isfinite(jl[2]) and jl[2] > 1e29
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-5)
    # row 3 has no label: the all-blank path's negative log-probability
    lp = torch.log_softmax(torch.from_numpy(L.CTC_LOGITS[:7, 3]), -1)
    np.testing.assert_allclose(tl[3], -lp[:, 0].sum().item(), rtol=1e-5)
    # torch's own CTC gives inf on the infeasible row (hence the recursion)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(L.CTC_LOGITS), -1),
        torch.from_numpy(L.CTC_LABELS), torch.from_numpy(L.CTC_IN),
        torch.from_numpy(L.CTC_LAB), reduction="none")
    assert torch.isinf(ref[2])
    np.testing.assert_allclose(ref[[0, 1, 3]].numpy(), tl[[0, 1, 3]],
                               rtol=1e-5)


def test_warpctc_drops_norm_by_times_as_the_jax_op():
    args = [tp.to_tensor(a) for a in (L.CTC_LOGITS, L.CTC_LABELS, L.CTC_IN,
                                      L.CTC_LAB)]
    a = tp.ops.warpctc(*args, norm_by_times=True)
    b = tp.ops.warpctc(*args)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_viterbi_path_is_the_crf_argmax():
    """The decoded path has the least CRF NLL of all paths (every path of
    the 4 tags over 5 steps, enumerated)."""
    import itertools
    em, tr = tp.to_tensor(L.CRF_EM), tp.to_tensor(L.CRF_TR)
    lens = tp.to_tensor(L.CRF_LEN)
    _, path = tp.ops.viterbi_decode(em, tr, lens)
    nll = tp.ops.linear_chain_crf(em, tr, path, lens).numpy()
    best = np.full(3, np.inf)
    for p in itertools.product(range(4), repeat=5):
        y = tp.to_tensor(np.tile(np.asarray(p, np.int64), (3, 1)))
        best = np.minimum(best, tp.ops.linear_chain_crf(em, tr, y,
                                                        lens).numpy())
    np.testing.assert_allclose(nll, best, rtol=1e-5, atol=1e-5)


def test_known_difference_x64_splits_an_infeasible_rows_gradient():
    """The sandbox's JAX package runs with x64 on (ROADMAP Queue 3, D):
    its CTC alpha starts from ``jnp.full(..., NEG)``, then f64, and on an
    infeasible row the gradient through the ties of impossible states
    comes out differently at the first frame than the same op's with x64
    off (its TPU dtype). The port is the f32 recursion's on every row, and
    the x64 op's on every feasible row and every other frame."""
    import jax
    rs = np.random.RandomState(3)
    logits = (rs.randn(40, 4, 6) * 2).astype(np.float32)
    labels = rs.randint(1, 6, (4, 10)).astype(np.int64)
    il = np.array([40, 33, 28, 8], np.int64)            # row 3 infeasible
    ll = np.array([10, 7, 9, 10], np.int64)

    def grad(pkg):
        x = pkg.to_tensor(logits, stop_gradient=False)
        pkg.ops.ctc_loss(x, *[pkg.to_tensor(a) for a in (labels, il, ll)],
                         reduction="none").sum().backward()
        return np.asarray(x.grad.numpy())

    g64 = grad(jp)
    with jax.enable_x64(False):
        g32 = grad(jp)
    gt = grad(tp)
    np.testing.assert_allclose(gt, g32, rtol=1e-4, atol=1e-6)
    assert np.abs(g64[1, 3] - g32[1, 3]).max() > 1e-2      # the quirk
    rest = np.ones(g64.shape[:2], bool)
    rest[1, 3] = False
    np.testing.assert_allclose(gt[rest], g64[rest], rtol=1e-4, atol=1e-6)


def test_known_difference_an_f64_input_stays_f64():
    """The JAX ops cast the logits / emissions to f32; the port's keep an
    f64 input in f64 (so a host run in f64 references the card's f32, as
    chip_smoke.py phase 28 uses it). f32 inputs, the only ones the JAX
    package's models give, run in f32 in both."""
    em64 = tp.to_tensor(L.CRF_EM, dtype="float64")
    tr64 = tp.to_tensor(L.CRF_TR, dtype="float64")
    y = tp.to_tensor(L.CRF_Y)
    nll = tp.ops.linear_chain_crf(em64, tr64, y)
    assert nll.dtype == torch.float64
    j = jp.ops.linear_chain_crf(jp.to_tensor(L.CRF_EM), jp.to_tensor(
        L.CRF_TR), jp.to_tensor(L.CRF_Y))
    np.testing.assert_allclose(nll.numpy(), np.asarray(j.numpy()), rtol=1e-5)
    ctc = tp.ops.ctc_loss(tp.to_tensor(L.CTC_LOGITS, dtype="float64"),
                          *[tp.to_tensor(a) for a in (L.CTC_LABELS, L.CTC_IN,
                                                      L.CTC_LAB)],
                          reduction="none")
    assert ctc.dtype == torch.float64
