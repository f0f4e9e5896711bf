"""Port parity: gradient clipping (paddle_tpu_torch/optimizer/clip.py)
against paddle_tpu.optimizer.clip.

Each clip runs on the same three grads in both packages, in f32, bf16 and
f16, with its threshold below and above the grads' size (clipping and
not), through ``apply`` (the optimizer's ``{name: grad}`` form) and
``__call__`` (``[(param, grad)]`` pairs). Results keep each grad's dtype.
Tolerance: f32 1e-6 relative (the global norm is summed per tensor here,
over all elements at once there); bf16 / f16 one ulp of the element
(2^-8 / 2^-11 relative), since a scale that differs in its last f32 bit
can flip a rounding to the 16-bit type. ClipGradByNorm works in the
grad's dtype, where the norm and the scale are each rounded once more
(torch sums the 16-bit squares in f32, XLA in another order): three ulps
(readings: bf16 2.0, f16 1.7). ClipGradByValue is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu_torch.optimizer import clip as tclip

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8),
          "float16": (jnp.float16, torch.float16, 2.0 ** -11)}


def _grads(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(np.float32),
            "b": rng.randn(5).astype(np.float32) * 3,
            "e": rng.randn(4, 3).astype(np.float32) * 0.1}


def _global_norm(g):
    return float(np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                             for v in g.values())))


def _clips(mod, kind, size):
    """A clip of ``kind`` whose threshold is below (clips) or above the
    grads' size."""
    if kind == "value":
        return mod.ClipGradByValue(max=size, min=-0.8 * size)
    if kind == "norm":
        return mod.ClipGradByNorm(clip_norm=size)
    return mod.ClipGradByGlobalNorm(clip_norm=size)


def _size(kind, g, clips):
    if kind == "value":
        return 0.7 if clips else 100.0
    if kind == "norm":
        return 1.5 if clips else 1e3
    return 0.5 * _global_norm(g) if clips else 2 * _global_norm(g)


def _as_np(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("clips", [True, False])
def test_clip_matches_jax(kind, dtype, clips):
    jd, td, rtol = DTYPES[dtype]
    g = _grads()
    size = _size(kind, g, clips)
    jout = _clips(jclip, kind, size).apply(
        {k: jnp.asarray(v, jd) for k, v in g.items()})
    tin = {k: torch.from_numpy(v).to(td) for k, v in g.items()}
    tout = _clips(tclip, kind, size).apply(tin)
    changed = False
    for k in g:
        assert tout[k].dtype == td
        want, got = _as_np(jout[k]), tout[k].float().numpy()
        if kind == "value":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            ulps = 3 if kind == "norm" and dtype != "float32" else 1
            np.testing.assert_allclose(got, want, rtol=ulps * rtol, atol=0,
                                       err_msg=k)
        changed |= not torch.equal(tout[k], tin[k])
    assert changed == clips
    if kind == "global_norm" and clips:
        total = np.sqrt(sum((tout[k].double() ** 2).sum().item() for k in g))
        assert abs(total - size) <= 1e-2 * size


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_param_grad_pairs_match_apply(kind):
    g = _grads(1)
    size = _size(kind, g, True)
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()]
    pairs = list(zip(params, (torch.from_numpy(v) for v in g.values())))
    out = _clips(tclip, kind, size)(pairs)
    ref = _clips(tclip, kind, size).apply(dict(zip(g, (p[1] for p in pairs))))
    jpairs = _clips(jclip, kind, size)(
        [(None, Tensor(jnp.asarray(v), _internal=True)) for v in g.values()])
    for (p, got), (pp, _), k, (_, jg) in zip(out, pairs, g, jpairs):
        assert p is pp
        assert torch.equal(got, ref[k])
        np.testing.assert_allclose(got.numpy(), _as_np(jg._value), rtol=1e-6)


def test_empty_grads():
    for kind in ("value", "norm", "global_norm"):
        assert _clips(tclip, kind, 1.0).apply({}) == {}
