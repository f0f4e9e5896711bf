"""Port parity in f16: the decode-attention plain versions
(paddle_tpu_torch/ops/cuda/decode_attention.py) against the JAX Pallas
kernels in interpret mode, contiguous and paged, as the JAX kernels take
any float dtype: q is cast to the cache's dtype, the output comes back in
q's. And the wrappers' choice of kernel for f16 (the card's mma chunk
kernel takes f16 as bf16).

Tolerance, f16: both sides form the scores and the softmax in f32 from
the same f16 values, so they differ by the f32 summation order, one f16
rounding of an f16 output, and, over an f16 cache, the JAX kernel's
rounding of P to the cache's dtype before P . V
(paddle_tpu/ops/pallas/decode_attention.py:81; the plain version keeps P
in f32): 2e-3 absolute for outputs of magnitude below 2 (an f16 ulp there
is 2^-10 to 2^-9).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import kv_pool as jpool
from paddle_tpu.ops.pallas.decode_attention import (decode_attention as
                                                    j_decode,
                                                    paged_decode_attention
                                                    as j_paged)
from paddle_tpu_torch.ops.cuda import decode_attention, paged_decode_attention
from paddle_tpu_torch.ops.cuda.decode_attention import _MMA, _SPLIT, _plan

F16_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: one intra-op thread leaves the other cores to the
    timing-sensitive tests that run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret():
    paddle.set_flags({"FLAGS_pallas_interpret": True})
    yield
    paddle.set_flags({"FLAGS_pallas_interpret": False})


def _inputs(rng, b, h, s, d, L, qdt, cdt):
    q = rng.randn(b, h, s, d).astype(qdt)
    kc = rng.randn(b, h, L, d).astype(cdt)
    vc = rng.randn(b, h, L, d).astype(cdt)
    return q, kc, vc


@pytest.mark.parametrize("qdt, cdt", [(np.float16, np.float16),
                                      (np.float32, np.float16),
                                      (np.float16, np.float32)])
@pytest.mark.parametrize("s, fill", [(1, 0), (1, 77), (12, 40), (32, 96)])
def test_contiguous_f16_matches_jax(interpret, qdt, cdt, s, fill):
    rng = np.random.RandomState(s + fill)
    b, h, d, L = 2, 3, 16, 128
    q, kc, vc = _inputs(rng, b, h, s, d, L, qdt, cdt)
    jk = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.int32(fill)))
    out = decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc)), fill)
    assert out.dtype == torch.from_numpy(q).dtype
    assert jk.dtype == q.dtype
    np.testing.assert_allclose(out.float().numpy(), jk.astype(np.float32),
                               atol=F16_ATOL)


@pytest.mark.parametrize("s", [1, 12])
def test_contiguous_f16_ragged_fills_match_jax(interpret, s):
    rng = np.random.RandomState(5)
    b, h, d, L = 4, 2, 32, 256
    q, kc, vc = _inputs(rng, b, h, s, d, L, np.float16, np.float16)
    fills = np.asarray([0, 17, 130, L - s], np.int32)
    jk = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.asarray(fills)))
    out = decode_attention(*(torch.from_numpy(x) for x in (q, kc, vc)),
                           torch.from_numpy(fills))
    np.testing.assert_allclose(out.float().numpy(), jk.astype(np.float32),
                               atol=F16_ATOL)


@pytest.mark.parametrize("s", [1, 12])
def test_paged_f16_matches_jax(interpret, s):
    rng = np.random.RandomState(s + 3)
    b, h, d, bs, MB, NB = 4, 2, 16, 16, 5, 20
    fills = [10 - min(s, 9), 16, 37, MB * bs - s]
    pool = jpool.KVBlockPool(NB, bs)
    every = pool.alloc(NB)
    pool.free([every[i] for i in rng.permutation(NB)])
    bt = np.zeros((b, MB), np.int32)
    for i, ln in enumerate(fills):
        blocks = pool.alloc(pool.blocks_for(ln + s))
        bt[i, :len(blocks)] = blocks
    ka = rng.randn(NB + 1, h, bs, d).astype(np.float16)
    va = rng.randn(NB + 1, h, bs, d).astype(np.float16)
    q = rng.randn(b, h, s, d).astype(np.float16)
    lens = np.asarray(fills, np.int32)
    jk = np.asarray(j_paged(*(jnp.asarray(x) for x in (q, ka, va, bt,
                                                       lens))))
    out = paged_decode_attention(*(torch.from_numpy(x)
                                   for x in (q, ka, va, bt, lens)))
    assert out.dtype == torch.float16 and jk.dtype == np.float16
    np.testing.assert_allclose(out.float().numpy(), jk.astype(np.float32),
                               atol=F16_ATOL)


@pytest.mark.parametrize("s, want", [(1, _SPLIT), (7, _MMA), (300, _MMA)])
def test_plan_sends_f16_to_the_hopper_kernels(s, want):
    q = torch.zeros(2, 3, s, 64, dtype=torch.float16)
    kc = torch.zeros(2, 3, 512, 64, dtype=torch.float16)
    assert _plan(q, kc, kc, 512, 132)[0] == want
    # mixed types are no mma call
    if want == _MMA:
        assert _plan(q, kc.to(torch.bfloat16), kc.to(torch.bfloat16), 512,
                     132)[0] != _MMA
