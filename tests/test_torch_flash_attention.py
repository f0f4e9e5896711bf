"""Port parity: flash attention (paddle_tpu_torch/ops/cuda/flash_attention.py)
and its dispatch gate (nn/functional.py) against the JAX package's Pallas
kernels, run in interpret mode as tests/test_flash_attention.py runs them.

On the CPU the port's wrappers run their plain versions through the same
``torch.autograd.Function`` the card uses. Every case feeds both packages
the same numpy inputs and compares O, lse and dq/dk/dv (of sum(O * g)).
Tolerances are those of tests/test_flash_attention.py: f32 outputs 2e-5
and gradients 5e-5 absolute, 1e-4 for the ragged shapes (the JAX wrapper
pads them to a multiple of 8; both sides sum in f32 in different orders).
bf16: outputs and gradients 1.6e-2 absolute, two bf16 ulps of the values
of this size (|x| < 2): both sides round O, P and dS to bf16 at the same
places, so what is left is a rounding flip between f32 sums taken in
different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import _sdpa as jsdpa
from paddle_tpu.ops.pallas import flash_attention as jflash
from paddle_tpu.ops.pallas.flash_attention import supported as jsupported
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cuda as kernels
from paddle_tpu_torch.ops.cuda import (flash_attention, flash_bwd_ref,
                                       flash_fwd, flash_fwd_ref)
from paddle_tpu_torch.ops.cuda.flash_attention import flash_delta, supported


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are tiny: one intra-op thread is enough, and it leaves
    the other cores to the timing-sensitive tests that run beside this
    file in a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_OUT, F32_GRAD, RAGGED, BF16 = 2e-5, 5e-5, 1e-4, 1.6e-2

# (b, h, s_q, s_k, d, causal, bias, dtype, tolerance of outputs, of grads):
# the shapes of tests/test_flash_attention.py
CASES = {
    "square": (2, 3, 32, 32, 16, False, False, "float32", F32_OUT, F32_GRAD),
    "causal": (1, 2, 64, 64, 32, True, False, "float32", F32_OUT, F32_GRAD),
    "bias": (2, 2, 32, 64, 8, False, True, "float32", F32_OUT, F32_GRAD),
    "causal_bias": (2, 2, 32, 64, 16, True, True, "float32", F32_OUT,
                    F32_GRAD),
    "odd_square": (2, 2, 33, 33, 16, False, False, "float32", RAGGED, RAGGED),
    "odd_causal": (2, 2, 33, 33, 16, True, False, "float32", RAGGED, RAGGED),
    "ragged_bias": (2, 2, 7, 65, 16, False, True, "float32", RAGGED, RAGGED),
    "one_row_causal": (2, 2, 1, 40, 16, True, False, "float32", RAGGED,
                       RAGGED),
    "rect_causal_8x64": (1, 2, 8, 64, 16, True, False, "float32", F32_OUT,
                         F32_GRAD),
    "rect_causal_32x64": (1, 2, 32, 64, 16, True, False, "float32", F32_OUT,
                          F32_GRAD),
    "lse": (1, 1, 32, 32, 8, False, False, "float32", F32_OUT, F32_GRAD),
    "bf16": (1, 2, 64, 64, 32, False, False, "bfloat16", BF16, BF16),
    "bf16_causal_bias": (2, 2, 64, 64, 32, True, True, "bfloat16", BF16,
                         BF16),
}


def _inputs(b, h, sq, sk, d, with_bias, seed=0):
    """q, k, v, upstream g ~ N(0, 1) and a key bias with 30% of the keys
    at -1e9 (key 0 kept, so no causal row is left without a key)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32)
               for s in (sq, sk, sk))
    g = rng.randn(b, h, sq, d).astype(np.float32)
    bias = None
    if with_bias:
        bias = np.where(rng.rand(b, sk) < 0.3, -1e9, 0.0).astype(np.float32)
        bias[:, 0] = 0.0
    return q, k, v, g, bias


def _jax(q, k, v, g, bias, causal, dtype):
    """(O, lse, (dq, dk, dv)) of the JAX kernel, f32 numpy; one jitted
    call (the interpreted kernels' grids compile to loops)."""
    dt = jnp.dtype(dtype)

    @jax.jit
    def run(q_, k_, v_, g_, b_):
        out, lse = jflash(q_, k_, v_, bias=b_, causal=causal,
                          return_lse=True)
        grads = jax.grad(lambda *a: jnp.sum(
            jflash(*a, bias=b_, causal=causal).astype(jnp.float32) * g_),
            argnums=(0, 1, 2))(q_, k_, v_)
        return out, lse, grads

    out, lse, grads = run(*(jnp.asarray(x, dt) for x in (q, k, v)),
                          jnp.asarray(g),
                          None if bias is None else jnp.asarray(bias))
    f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return f32(out), f32(lse), [f32(x) for x in grads], out.dtype


def _port(q, k, v, g, bias, causal, dtype):
    dt = getattr(torch, dtype)
    ts = [torch.tensor(x).to(dt).requires_grad_() for x in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)
    out = flash_attention(*ts, bias=tb, causal=causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    out2, lse = flash_attention(*ts, bias=tb, causal=causal,
                                return_lse=True)
    assert torch.equal(out2, out) and not lse.requires_grad
    return (out.detach().float().numpy(), lse.numpy(),
            [t.grad.float().numpy() for t in ts], out.dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_matches_jax_kernel(case):
    b, h, sq, sk, d, causal, with_bias, dtype, tol_o, tol_g = CASES[case]
    q, k, v, g, bias = _inputs(b, h, sq, sk, d, with_bias)
    jo, jl, jg, jdt = _jax(q, k, v, g, bias, causal, dtype)
    to, tl, tg, tdt = _port(q, k, v, g, bias, causal, dtype)
    assert str(tdt).split(".")[-1] == str(jdt) == dtype
    assert to.shape == (b, h, sq, d) and tl.shape == (b, h, sq)
    np.testing.assert_allclose(to, jo, atol=tol_o)
    np.testing.assert_allclose(tl, jl, atol=max(tol_o, 2e-5))
    for name, t, j in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(t, j, atol=tol_g, err_msg=name)


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-written plain backward (the kernels' oracle) against torch
    autograd through the plain forward, f32, causal with a bias."""
    q, k, v, g, bias = _inputs(2, 2, 24, 40, 16, True, seed=1)
    ts = [torch.tensor(x.reshape(4, -1, 16), requires_grad=True)
          for x in (q, k, v)]
    gt = torch.from_numpy(g.reshape(4, -1, 16))
    tb = torch.from_numpy(bias)
    o, lse = flash_fwd_ref(*ts, tb, True)
    (o * gt).sum().backward()
    dq, dk, dv = flash_bwd_ref(*(t.detach() for t in ts), tb, o.detach(),
                               lse.detach(), gt, True)
    for ours, t in zip((dq, dk, dv), ts):
        np.testing.assert_allclose(ours.numpy(), t.grad.numpy(),
                                   atol=F32_GRAD)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    q, k, v, _, bias = _inputs(2, 2, 16, 16, 8, True, seed=2)
    args = [torch.from_numpy(x.reshape(4, 16, 8)) for x in (q, k, v)]
    before = kernels.launch_counts()
    o, lse = flash_fwd(*args, torch.from_numpy(bias), True)
    ro, rl = flash_fwd_ref(*args, torch.from_numpy(bias), True)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert kernels.launch_counts() == before
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= set(before)
    assert len(kernels.KERNELS) == 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 40, 64, 128, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_sm90_dispatch(dtype, d, aligned):
    """bf16 and f16 at head dim 64 or 128 with aligned inputs take the
    Hopper forward, dq and dk/dv; everything else flash_attention.cu's
    kernels. The three wrappers' entry points follow this one gate."""
    import importlib
    fa = importlib.import_module("paddle_tpu_torch.ops.cuda.flash_attention")
    want = dtype != torch.float32 and d in (64, 128) and aligned
    assert fa._sm90_path(dtype, d, aligned) is want
    source = "flash_sm90" if want else "flash_attention"
    for kernel in ("fwd", "bwd_dq", "bwd_dkv"):
        entry = fa._entry(kernel, dtype, d, aligned)
        assert entry == f"{source}_{kernel}" and entry in fa._SIGS


def test_planted_fault_lines_occur_once():
    """Each of chip_smoke.py's planted faults names a line that occurs
    exactly once in its source (a kernel source, or a module of the op
    core), so ``--faults`` changes that line and nothing else."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sources = set()
    for name, (source, old, new) in smoke.FAULTS.items():
        text = (root / smoke.fault_path(source)).read_text()
        assert text.count(old) == 1, name
        assert old != new and text.replace(old, new).count(new) >= 1, name
        sources.add(source)
    assert sources == {"flash_attention.cu", "flash_attention_sm90.cu",
                       "fused_ce_sm90.cu", "decode_attention.cu",
                       "paddle_tpu_torch/ops/cuda/decode_attention.py",
                       "paddle_tpu_torch/ops/_dispatch.py",
                       "paddle_tpu_torch/core/tensor.py",
                       "paddle_tpu_torch/nn/layer/transformer.py",
                       "paddle_tpu_torch/ops/conv.py",
                       "paddle_tpu_torch/nn/decode.py",
                       "paddle_tpu_torch/static/pipeline_runner.py",
                       "paddle_tpu_torch/io/fleet_dataset.py",
                       "paddle_tpu_torch/incubate/checkpoint.py",
                       "paddle_tpu_torch/static/executor.py",
                       "paddle_tpu_torch/distributed/ps/client.py",
                       "paddle_tpu_torch/distributed/ps/heter.py"}


def test_cpu_wrappers_count_no_launch_of_either_variant():
    """bf16 d 64 CPU tensors (the Hopper kernels' inputs on the card) run
    the plain versions: no total and no Hopper launch is counted, and the
    outputs (O, lse, dq, dk, dv) are the plain versions' bit for bit."""
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rng.randn(4, s, 64).astype(np.float32))
                   .to(torch.bfloat16) for s in (24, 40, 40, 24))
    bias = torch.from_numpy(rng.randn(2, 40).astype(np.float32))
    kernels.reset_launch_counts()
    o, lse = flash_fwd(q, k, v, bias, True)
    dq = kernels.flash_bwd_dq(q, k, v, bias, do, lse, flash_delta(o, do),
                              True)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, bias, do, lse,
                                   flash_delta(o, do), True)
    ro, rl = flash_fwd_ref(q, k, v, bias, True)
    rq, rk, rv = flash_bwd_ref(q, k, v, bias, o, lse, do, True)
    assert torch.equal(o, ro) and torch.equal(lse, rl)
    assert torch.equal(dq, rq)
    assert torch.equal(dk, rk) and torch.equal(dv, rv)
    counts = kernels.launch_counts()
    assert set(kernels.VARIANTS) == {"flash_fwd.sm90", "flash_bwd_dq.sm90",
                                     "flash_bwd_dkv.sm90",
                                     "fused_ce_fwd.sm90",
                                     "fused_ce_bwd_dh.sm90",
                                     "fused_ce_bwd_dw.sm90",
                                     "decode_attention.sm90",
                                     "paged_decode_attention.sm90"}
    assert all(n == 0 for n in counts.values()), counts


def test_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError, match="match"):
        flash_fwd(q, torch.zeros(4, 9, 16), torch.zeros(4, 8, 16))
    with pytest.raises(ValueError, match="bias"):
        flash_fwd(q, q, q, torch.zeros(3, 8))


@pytest.mark.parametrize("shapes", [
    ((2, 2, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16), None),
    ((2, 2, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16), (1, 1, 1, 32)),
    ((2, 2, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16), (2, 1, 1, 1)),
    ((2, 2, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16), (2, 1, 1, 32)),
    ((1, 2, 32, 16), (1, 2, 32, 16), (1, 2, 32, 32), None),
    ((1, 2, 33, 16), (1, 2, 33, 16), (1, 2, 33, 16), None),
    ((1, 2, 8, 300), (1, 2, 8, 300), (1, 2, 8, 300), None),
    ((1, 2, 8, 256), (1, 2, 9, 256), (1, 2, 9, 256), (1, 1, 1, 9)),
    ((2, 8, 16), (2, 8, 16), (2, 8, 16), None),
])
def test_supported_matches_jax(shapes):
    assert supported(*shapes) == jsupported(*shapes)


# --------------------------------------------------------------------------
# the gate of scaled_dot_product_attention
# --------------------------------------------------------------------------

@pytest.fixture
def gate_flags():
    names = ("FLAGS_use_flash_attention", "FLAGS_flash_min_seq")
    saved = {n: tflags.flag(n) for n in names}
    yield tflags
    tflags.set_flags(saved)


def _route(flags_, q, k, v, mask=None, causal=False):
    """The counter the call bumps: 'hit' or the gate's reject reason; and
    the output against the composite's."""
    monitor.reset(prefix="cuda.")
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         is_causal=causal)
    ref = F._sdpa(q, k, v, mask, q.shape[-1] ** -0.5, causal)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=F32_OUT)
    stats = monitor.stats("cuda.")
    assert len(stats) == 1, stats
    name = next(iter(stats))
    return name.rsplit(".", 1)[-1] if "gate_reject" in name else "hit"


@pytest.mark.parametrize("route", ["hit", "flag_off", "min_seq",
                                   "mask_grad", "mask_shape", "head_dim"])
def test_gate_routes(gate_flags, route):
    rng = np.random.RandomState(3)
    b, h, s, d = 2, 2, 32, 16
    if route == "head_dim":
        d = 264
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(
        np.where(rng.rand(b, 1, 1, s) < 0.3, -1e9, 0.0).astype(np.float32))
    mask[..., 0] = 0.0
    gate_flags.set_flags({"FLAGS_flash_min_seq": 0})
    want = {"hit": "hit", "flag_off": "flag_off", "min_seq": "min_seq",
            "mask_grad": "mask_grad", "mask_shape": "shape",
            "head_dim": "shape"}[route]
    if route == "flag_off":
        gate_flags.set_flags({"FLAGS_use_flash_attention": False})
    if route == "min_seq":
        gate_flags.set_flags({"FLAGS_flash_min_seq": s + 1})
    if route == "mask_grad":
        mask.requires_grad_()
    if route == "mask_shape":
        mask = mask[:1]
    before = kernels.launch_counts()
    assert _route(gate_flags, q, k, v, mask, causal=True) == want
    assert kernels.launch_counts() == before      # CPU: plain versions


def test_gate_takes_bool_masks_as_bias(gate_flags):
    """A bool [b, 1, 1, s_k] mask becomes the bias where(m, 0, -1e9)."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 16, 8).astype(np.float32))
               for _ in range(3))
    keep = torch.from_numpy(rng.rand(2, 1, 1, 16) > 0.3)
    keep[..., 0] = True
    gate_flags.set_flags({"FLAGS_flash_min_seq": 0})
    assert _route(gate_flags, q, k, v, keep) == "hit"


def test_default_min_seq_routes_short_sequences_to_the_composite(gate_flags):
    """Below the default FLAGS_flash_min_seq the gate takes the composite
    (the JAX package's rule, with the H100's threshold)."""
    s = int(tflags.flag("FLAGS_flash_min_seq")) - 1
    q = torch.from_numpy(
        np.random.RandomState(5).randn(1, 1, s, 8).astype(np.float32))
    assert _route(gate_flags, q, q, q) == "min_seq"


# --------------------------------------------------------------------------
# reference quirks (ROADMAP Queue 3)
# --------------------------------------------------------------------------

def test_quirk_bf16_composite_with_f32_mask():
    """The JAX composite promotes bf16 q/k/v under an f32 additive mask to
    f32; its flash route, and the port's composite, keep bf16. The values
    agree to bf16 rounding."""
    q, k, v, _, bias = _inputs(1, 2, 16, 16, 8, True, seed=6)
    mask = bias[:, None, None, :]
    jout = jsdpa.raw(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     jnp.asarray(mask), 8 ** -0.5, False)
    tout = F._sdpa(*(torch.from_numpy(x).to(torch.bfloat16)
                     for x in (q, k, v)), torch.from_numpy(mask),
                   8 ** -0.5, False)
    assert jout.dtype == jnp.float32 and tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout),
                               atol=BF16)


def test_quirk_causal_rows_without_a_visible_key():
    """Causal s_q > s_k leaves rows that see no key (outside the
    contract). In the JAX kernel their output depends on its tiles: 0
    where the whole query tile is dead (rows 0-127 here, tile 128), the
    mean of V over the live tiles' keys elsewhere. The port's plain
    version gives the mean of V for every such row; the rows that see
    keys agree."""
    q, k, v, _, _ = _inputs(1, 1, 256, 8, 8, False, seed=7)
    jo = np.asarray(jflash(*(jnp.asarray(x) for x in (q, k, v)),
                           causal=True))
    to = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=True).numpy()
    blind = 256 - 8
    mean_v = v[0, 0].mean(0)
    np.testing.assert_allclose(jo[0, 0, :128], 0.0)
    np.testing.assert_allclose(jo[0, 0, 128:blind], np.broadcast_to(
        mean_v, (blind - 128, 8)), atol=F32_OUT)
    np.testing.assert_allclose(to[0, 0, :blind], np.broadcast_to(
        mean_v, (blind, 8)), atol=F32_OUT)
    np.testing.assert_allclose(to[0, 0, blind:], jo[0, 0, blind:],
                               atol=F32_OUT)
