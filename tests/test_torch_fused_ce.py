"""Port parity: the fused linear + cross-entropy head
(paddle_tpu_torch/ops/cuda/fused_ce.py, nn/functional.py) against the JAX
package's Pallas kernels run in interpret mode, as tests/test_fused_ce.py
runs them.

On the CPU the port's wrappers run their plain versions through the same
``torch.autograd.Function`` the card uses. f32 throughout. Tolerances:
loss 1e-6 and grads 1e-5 absolute; both sides compute the same f32 sums
in different orders (XLA's blocked interpret kernel, torch's CPU matmul).

Out-of-range labels are -5 and 10**6: the JAX wrapper pads the vocab to a
multiple of 128, and a label inside that padding (here [517, 640)) would
match a masked padding column there, while on the card no padded column
exists. Labels that miss every column, padded or not, have the same
meaning in both: loss = lse.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy as jk
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda as kernels
from paddle_tpu_torch.ops.cuda import (fused_ce_bwd, fused_ce_bwd_dh,
                                       fused_ce_bwd_dw, fused_ce_bwd_ref,
                                       fused_ce_fwd, fused_ce_fwd_ref)

# the module (the package's attribute ``fused_ce`` is the function)
fused_ce_mod = importlib.import_module("paddle_tpu_torch.ops.cuda.fused_ce")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are tiny: one intra-op thread is enough, and it leaves
    the other cores to the timing-sensitive tests that run beside this
    file in a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
V = 517


@pytest.fixture
def interpret():
    paddle.set_flags({"FLAGS_pallas_interpret": True})
    yield
    paddle.set_flags({"FLAGS_pallas_interpret": False})


def _case(kind, seed=0, n=48, hd=32, vocab=V):
    """h, w, b, y, upstream g as numpy. ~30% ignored rows; "oob" adds
    out-of-range labels; "all_ignored" ignores every row."""
    rng = np.random.RandomState(seed)
    h = rng.randn(n, hd).astype(np.float32)
    w = (0.2 * rng.randn(vocab, hd)).astype(np.float32)
    b = (0.1 * rng.randn(vocab)).astype(np.float32)
    y = np.where(rng.rand(n) < 0.3, -100, rng.randint(0, vocab, n))
    if kind == "oob":
        y[1], y[2] = -5, 10 ** 6
    if kind == "all_ignored":
        y[:] = -100
    g = rng.rand(n).astype(np.float32)
    return h, w, b, y.astype(np.int64), g


def _jax(h, w, b, y, g):
    """Per-token losses and (dh, dW, db) of sum(loss * g) from the JAX
    kernel (interpret mode)."""
    def f(h_, w_, b_):
        return jk(h_, w_, b_, jnp.asarray(y, jnp.int32))

    args = (jnp.asarray(h), jnp.asarray(w),
            None if b is None else jnp.asarray(b))
    loss = np.asarray(f(*args))
    argnums = (0, 1) if b is None else (0, 1, 2)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(g)),
                     argnums=argnums)(*args)
    return loss, [np.asarray(x) for x in grads]


def _port(h, w, b, y, g, reduction="none", dtype=torch.float32):
    ts = [torch.tensor(x).to(dtype).requires_grad_()
          for x in ((h, w) if b is None else (h, w, b))]
    tb = ts[2] if b is not None else None
    loss = F.fused_linear_cross_entropy(ts[0], ts[1], tb,
                                        torch.from_numpy(y),
                                        reduction=reduction)
    (loss * torch.from_numpy(g)).sum().backward()
    return loss.detach().numpy(), [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("kind", ["mixed", "oob", "all_ignored"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_per_token_loss_and_grads_match_jax(interpret, kind, with_bias):
    h, w, b, y, g = _case(kind)
    b = b if with_bias else None
    jl, jg = _jax(h, w, b, y, g)
    tl, tg = _port(h, w, b, y, g)
    np.testing.assert_allclose(tl, jl, atol=LOSS_TOL)
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, atol=GRAD_TOL)
    ignored = y == -100
    assert (tl[ignored] == 0).all()
    if kind == "oob":
        _, lse = fused_ce_fwd_ref(torch.from_numpy(h), torch.from_numpy(w),
                                  None if b is None else torch.from_numpy(b),
                                  torch.from_numpy(y))
        np.testing.assert_allclose(tl[1:3], lse.numpy()[1:3], atol=LOSS_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_reductions_match_jax(interpret, reduction):
    h, w, b, y, _ = _case("oob", seed=1, hd=24)
    ten = [paddle.to_tensor(x) for x in (h, w, b)]
    jl = np.asarray(JF.fused_linear_cross_entropy(
        ten[0].reshape([4, 12, 24]), ten[1], ten[2],
        paddle.to_tensor(y.reshape(4, 12)), reduction=reduction)._value)
    tl = F.fused_linear_cross_entropy(
        torch.from_numpy(h).reshape(4, 12, 24), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(y).reshape(4, 12),
        reduction=reduction)
    np.testing.assert_allclose(tl.numpy(), jl, atol=LOSS_TOL * 48)


def test_all_ignored_mean_is_zero():
    h, w, b, y, _ = _case("all_ignored", seed=2)
    loss = F.fused_linear_cross_entropy(torch.from_numpy(h),
                                        torch.from_numpy(w),
                                        torch.from_numpy(b),
                                        torch.from_numpy(y))
    assert float(loss) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_flag_off_composite_matches_jax_fallback(with_bias, dtype):
    """FLAGS_use_fused_ce off in both packages: the plain composite head
    (logits materialized), differentiated by each framework's autograd.

    bf16 (n 64, H 128, V 1000, W ~ N(0, 0.05^2)): both form the logits in
    bf16, so both round them there, then take an f32 lse. Limits: loss
    1e-5 absolute (the f32 lse of the same rounded logits, measured
    4.8e-7; unrounded f32 logits differ by 1.4e-3); each gradient one bf16
    ulp of its largest entry, 2^-8 of it (measured: dh equal, dW 1e-6 of
    it)."""
    bf16 = dtype == "bfloat16"
    if bf16:
        h, w, b, y, g = _case("mixed", seed=3, n=64, hd=128, vocab=1000)
        w = w / 4                                # 0.2 * N(0, 1) / 4
    else:
        h, w, b, y, g = _case("mixed", seed=3)
    b = b if with_bias else None
    xs = (h, w) if b is None else (h, w, b)
    paddle.set_flags({"FLAGS_use_fused_ce": False})
    tflags.set_flags({"FLAGS_use_fused_ce": False})
    try:
        jt = [paddle.to_tensor(jnp.asarray(x, dtype), stop_gradient=False)
              for x in xs]
        jl = JF.fused_linear_cross_entropy(
            jt[0], jt[1], jt[2] if b is not None else None,
            paddle.to_tensor(y), reduction="none")
        (jl * paddle.to_tensor(g)).sum().backward()
        before = kernels.launch_counts()
        tl, tg = _port(*xs[:2], b, y, g,
                       dtype=torch.bfloat16 if bf16 else torch.float32)
        assert kernels.launch_counts() == before
    finally:
        paddle.set_flags({"FLAGS_use_fused_ce": True})
        tflags.set_flags({"FLAGS_use_fused_ce": True})
    np.testing.assert_allclose(tl, np.asarray(jl._value),
                               atol=1e-5 if bf16 else LOSS_TOL)
    for t, j in zip(tg, jt):
        jg = np.asarray(j.grad._value.astype(jnp.float32))
        np.testing.assert_allclose(
            t, jg, atol=2 ** -8 * np.abs(jg).max() if bf16 else GRAD_TOL)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written plain backward (the kernels' oracle) against
    torch autograd through the plain forward."""
    h, w, b, y, g = _case("oob", seed=4)
    th, tw, tb = (torch.tensor(x, requires_grad=True) for x in (h, w, b))
    loss, lse = fused_ce_fwd_ref(th, tw, tb, torch.from_numpy(y))
    (loss * torch.from_numpy(g)).sum().backward()
    dh, dw, db = fused_ce_bwd_ref(th.detach(), tw.detach(), tb.detach(),
                                  torch.from_numpy(y), lse.detach(),
                                  torch.from_numpy(g))
    for ours, ref in ((dh, th.grad), (dw, tw.grad), (db, tb.grad)):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=GRAD_TOL)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    h, w, b, y, _ = _case("mixed", seed=5)
    args = [torch.from_numpy(x) for x in (h, w, b, y)]
    before = kernels.launch_counts()
    loss, lse = fused_ce_fwd(*args)
    ref_loss, ref_lse = fused_ce_fwd_ref(*args)
    assert torch.equal(loss, ref_loss) and torch.equal(lse, ref_lse)
    assert kernels.launch_counts() == before
    assert {"fused_ce_fwd", "fused_ce_bwd_dh",
            "fused_ce_bwd_dw"} <= set(before)


def test_wrapper_rejects_mismatched_shapes():
    h, w, b, y, _ = _case("mixed", seed=6)
    with pytest.raises(ValueError, match="labels"):
        fused_ce_fwd(torch.from_numpy(h), torch.from_numpy(w), None,
                     torch.from_numpy(y[:-1]))
    with pytest.raises(ValueError, match="bias"):
        fused_ce_fwd(torch.from_numpy(h), torch.from_numpy(w),
                     torch.from_numpy(b[:-1]), torch.from_numpy(y))


@pytest.mark.parametrize("need_dh", [True, False])
@pytest.mark.parametrize("need_dw", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_ce_bwd_matches_wrappers_and_plain(need_dh, need_dw,
                                                 with_bias):
    """``fused_ce_bwd`` on CPU tensors: for every mix of gradients asked
    for, the plain versions' gradients, the same as ``fused_ce_bwd_dh`` and
    ``fused_ce_bwd_dw`` give, None where not asked (db also without a
    bias), and no launch counted."""
    h, w, b, y, g = _case("oob", seed=7)
    args = [torch.from_numpy(h), torch.from_numpy(w),
            torch.from_numpy(b) if with_bias else None, torch.from_numpy(y)]
    _, lse = fused_ce_fwd_ref(*args)
    up = torch.from_numpy(g)
    before = kernels.launch_counts()
    dh, dw, db = fused_ce_bwd(*args, lse, up, need_dh=need_dh,
                              need_dw=need_dw)
    assert kernels.launch_counts() == before
    ref_dh, ref_dw, ref_db = fused_ce_bwd_ref(*args, lse, up)
    sep_dh = fused_ce_bwd_dh(*args, lse, up)
    sep_dw, sep_db = fused_ce_bwd_dw(*args, lse, up)
    if need_dh:
        assert torch.equal(dh, ref_dh) and torch.equal(dh, sep_dh)
    else:
        assert dh is None
    if need_dw:
        assert torch.equal(dw, ref_dw) and torch.equal(dw, sep_dw)
    else:
        assert dw is None
    if need_dw and with_bias:
        assert torch.equal(db, ref_db) and torch.equal(db, sep_db)
    else:
        assert db is None


def test_autograd_backward_is_one_fused_ce_bwd_call(monkeypatch):
    """The loss head's backward asks ``fused_ce_bwd`` once for dh, dW and
    db together (one recompute of the logits on the card)."""
    calls = []
    real = fused_ce_mod.fused_ce_bwd

    def spy(*a, **kw):
        calls.append(a[7:9])
        return real(*a, **kw)

    monkeypatch.setattr(fused_ce_mod, "fused_ce_bwd", spy)
    h, w, b, y, g = _case("mixed", seed=8)
    _port(h, w, b, y, g)
    assert calls == [(True, True)]


@pytest.mark.parametrize("vocab", [1, 63, 517, 30522, 50304])
@pytest.mark.parametrize("chunk", [128, 4096])
def test_vocab_chunks_cover_the_vocab_once(vocab, chunk):
    """The Hopper backward's chunk schedule: in order, adjacent, [0, V)
    once, every chunk ``chunk`` wide but a ragged last one."""
    sched = fused_ce_mod.vocab_chunks(vocab, chunk)
    assert sched[0][0] == 0
    assert sum(c for _, c in sched) == vocab
    for (v0, c), (v1, _) in zip(sched, sched[1:]):
        assert c == chunk and v1 == v0 + c
    last_v0, last = sched[-1]
    assert last_v0 + last == vocab and 1 <= last <= chunk
    assert len(sched) == -(-vocab // chunk)


@pytest.mark.parametrize("n,vocab", [(1, 517), (4096, 50304), (4096, 30522),
                                     (32768, 517), (100000, 50304)])
def test_vocab_chunk_width(n, vocab):
    """Vc: a multiple of the 128-column tile whose [n, Vc] ds chunk holds
    at most ``_CHUNK_ELEMS`` elements (or one tile), in as few chunks as
    that allows, and the narrowest such width: the chunks are near equal
    (the last at most one tile per chunk shorter than the rest)."""
    tile, cap = fused_ce_mod._GEMM_TILE, fused_ce_mod._CHUNK_ELEMS
    vc = fused_ce_mod.vocab_chunk(n, vocab)
    fit = max(tile, cap // n // tile * tile)
    chunks = -(-vocab // vc)
    assert vc % tile == 0 and tile <= vc <= fit
    assert n * vc <= cap or vc == tile
    assert chunks == -(-vocab // fit)            # as few chunks as fit
    assert (vc - tile) * chunks < vocab          # no narrower width covers
    last = vocab - (chunks - 1) * vc
    assert vc - last < chunks * tile


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("hd", [32, 64, 72, 128, 768, 1024, 1088])
def test_sm90_bwd_dispatch(dtype, hd):
    """bf16 and f16 with H a multiple of 64 up to 1024 take the Hopper
    backward; f32 and other H fused_ce.cu's dh and dW kernels."""
    want = dtype != torch.float32 and hd % 64 == 0 and hd <= 1024
    assert fused_ce_mod._sm90_bwd_path(dtype, hd) is want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("hd", [32, 64, 72, 768, 1024, 1088])
def test_sm90_fwd_dispatch(dtype, hd):
    """bf16 and f16 with H a multiple of 64 up to 1024 take the Hopper
    forward; f32 and other H fused_ce.cu's forward. (Above 1024 every CE
    wrapper raises.)"""
    want = dtype != torch.float32 and hd % 64 == 0 and hd <= 1024
    assert fused_ce_mod._sm90_fwd_path(dtype, hd) is want


def test_cpu_backward_counts_no_launch_of_either_variant():
    """bf16 CPU tensors at H 64 (the Hopper forward's and backward's inputs
    on the card) run the plain versions bit for bit and count no launch of
    either forward or either backward."""
    rng = np.random.RandomState(9)
    h = torch.from_numpy(rng.randn(20, 64).astype(np.float32)) \
        .to(torch.bfloat16)
    w = torch.from_numpy(0.2 * rng.randn(70, 64).astype(np.float32)) \
        .to(torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 70, 20))
    ref_loss, lse = fused_ce_fwd_ref(h, w, None, y)
    up = torch.ones(20)
    kernels.reset_launch_counts()
    loss, lse_k = fused_ce_fwd(h, w, None, y)
    assert torch.equal(loss, ref_loss) and torch.equal(lse_k, lse)
    dh, dw, db = fused_ce_bwd(h, w, None, y, lse, up)
    ref = fused_ce_bwd_ref(h, w, None, y, lse, up)
    assert torch.equal(dh, ref[0]) and torch.equal(dw, ref[1]) and db is None
    assert dh.dtype == dw.dtype == torch.bfloat16
    counts = kernels.launch_counts()
    assert {"fused_ce_fwd.sm90", "fused_ce_bwd_dh.sm90",
            "fused_ce_bwd_dw.sm90"} <= set(counts)
    assert all(c == 0 for c in counts.values()), counts
