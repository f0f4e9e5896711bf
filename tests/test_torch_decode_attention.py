"""Port parity: the decode-attention kernels' plain versions and the paged
pool pieces (paddle_tpu_torch/ops/cuda/decode_attention.py,
paddle_tpu_torch/nn/kv_pool.py) against the JAX package.

The same numpy inputs go through the JAX Pallas kernels in interpret mode
(FLAGS_pallas_interpret, as tests/test_decode_attention.py runs them), the
JAX jnp references, and the port. On the CPU the port's wrappers run
their plain versions. Tolerance: 1e-5 abs in f32 — both sides compute
the same f32 softmax; only the summation order differs (measured ~1e-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import kv_pool as jpool
from paddle_tpu.nn.layer.transformer import _static_cache_attention
from paddle_tpu.ops.pallas.decode_attention import (decode_attention as
                                                    j_decode,
                                                    paged_decode_attention
                                                    as j_paged)
from paddle_tpu_torch.nn import kv_pool as tpool
from paddle_tpu_torch.ops.cuda import (decode_attention, decode_attention_ref,
                                       paged_attention_ref,
                                       paged_decode_attention)
from paddle_tpu_torch.ops.cuda.decode_attention import (_MMA, _SCALAR,
                                                       _SPLIT, _TILE,
                                                       _kv_splits, _plan,
                                                       gather_pages)

ATOL = 1e-5


@pytest.fixture
def interpret():
    paddle.set_flags({"FLAGS_pallas_interpret": True})
    yield
    paddle.set_flags({"FLAGS_pallas_interpret": False})


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("index,s", [(0, 8), (0, 1), (17, 1), (96, 32),
                                     (127, 1), (50, 13)])
def test_contiguous_matches_jax(interpret, index, s):
    """Scalar fills from an empty cache to a full one (index + s == L),
    single-token and chunked (s > 8) queries."""
    rng = np.random.RandomState(index + s)
    b, h, d, L = 2, 3, 16, 128
    q = rng.randn(b, h, s, d).astype(np.float32)
    kc = rng.randn(b, h, L, d).astype(np.float32)
    vc = rng.randn(b, h, L, d).astype(np.float32)
    jk = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.int32(index)))
    jr = np.asarray(_static_cache_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(index),
        d ** -0.5, 0.0, False))
    out = decode_attention(_t(q), _t(kc), _t(vc), index).numpy()
    np.testing.assert_allclose(out, jk, atol=ATOL)
    np.testing.assert_allclose(out, jr, atol=ATOL)


@pytest.mark.parametrize("s", [1, 12])
def test_contiguous_ragged_fills_match_jax(interpret, s):
    """A [b] fill vector: every row attends to its own prefix."""
    rng = np.random.RandomState(1)
    b, h, d, L = 4, 2, 32, 256
    q = rng.randn(b, h, s, d).astype(np.float32)
    kc = rng.randn(b, h, L, d).astype(np.float32)
    vc = rng.randn(b, h, L, d).astype(np.float32)
    fills = np.asarray([0, 17, 130, L - s], np.int32)
    jk = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(kc),
                             jnp.asarray(vc), jnp.asarray(fills)))
    out = decode_attention(_t(q), _t(kc), _t(vc), _t(fills)).numpy()
    np.testing.assert_allclose(out, jk, atol=ATOL)
    assert decode_attention.launches == 0, "a CPU call never launches"


def _paged_inputs(rng, b, h, d, bs, MB, NB, fills, s):
    """Random arenas; block tables with each row's blocks taken from a
    shuffled JAX pool and trailing 0 (trash) entries."""
    pool = jpool.KVBlockPool(NB, bs)
    every = pool.alloc(NB)
    pool.free([every[i] for i in rng.permutation(NB)])     # shuffle
    bt = np.zeros((b, MB), np.int32)
    for i, ln in enumerate(fills):
        blocks = pool.alloc(pool.blocks_for(ln + s))
        bt[i, :len(blocks)] = blocks
    ka = rng.randn(NB + 1, h, bs, d).astype(np.float32)
    va = rng.randn(NB + 1, h, bs, d).astype(np.float32)
    q = rng.randn(b, h, s, d).astype(np.float32)
    return q, ka, va, bt, np.asarray(fills, np.int32)


@pytest.mark.parametrize("s", [1, 12])
def test_paged_matches_jax(interpret, s):
    """Fills from one partial block to a full table, against the JAX
    block-table kernel and its gather reference."""
    rng = np.random.RandomState(s)
    b, h, d, bs, MB, NB = 4, 2, 16, 16, 5, 20
    fills = [9 - min(s, 9) + 1, 16, 37, MB * bs - s]
    q, ka, va, bt, lens = _paged_inputs(rng, b, h, d, bs, MB, NB, fills, s)
    args = [jnp.asarray(x) for x in (q, ka, va, bt, lens)]
    jk = np.asarray(j_paged(*args))
    jr = np.asarray(jpool.paged_attention_ref(*args, d ** -0.5))
    out = paged_decode_attention(*(_t(x) for x in (q, ka, va, bt, lens)))
    np.testing.assert_allclose(out.numpy(), jk, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), jr, atol=ATOL)
    assert paged_decode_attention.launches == 0, "a CPU call never launches"


def test_paged_ref_equals_contiguous_ref_on_gathered_view():
    """The paged plain version is the contiguous one over the gathered
    blocks: same numbers, bit for bit."""
    rng = np.random.RandomState(3)
    b, h, d, bs, MB, NB = 3, 2, 8, 8, 4, 12
    q, ka, va, bt, lens = _paged_inputs(rng, b, h, d, bs, MB, NB,
                                        [0, 5, 20], 3)
    out = paged_attention_ref(*(_t(x) for x in (q, ka, va, bt, lens)))
    ref = decode_attention_ref(_t(q), gather_pages(_t(ka), _t(bt)),
                               gather_pages(_t(va), _t(bt)), _t(lens))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("s", [1, 5])
def test_write_kv_matches_jax(s):
    """Scatter into the arena: real rows land in their blocks, positions
    past the table and idle (all-zero table) rows land in the trash
    block, exactly where the JAX write_kv puts them."""
    rng = np.random.RandomState(4)
    b, h, d, bs, MB, NB = 3, 2, 4, 8, 3, 9
    arena = rng.randn(NB + 1, h, bs, d).astype(np.float32)
    bt = np.asarray([[3, 1, 0], [2, 4, 5], [0, 0, 0]], np.int32)
    lens = np.asarray([6, MB * bs - 2, 0], np.int32)
    new = rng.randn(b, s, h, d).astype(np.float32)
    ja = np.asarray(jpool.write_kv(jnp.asarray(arena), jnp.asarray(bt),
                                   jnp.asarray(lens), jnp.asarray(new)))
    ta = tpool.write_kv(_t(arena).clone(), _t(bt), _t(lens), _t(new))
    # the trash block takes colliding writes in an unspecified order
    np.testing.assert_array_equal(ta.numpy()[1:], ja[1:])


def test_pool_alloc_free_invariants():
    pool = tpool.KVBlockPool(4, 16)
    assert pool.free_blocks == 4 and pool.used_blocks == 0
    a = pool.alloc(3)
    assert len(a) == 3 and 0 not in a
    assert pool.alloc(2) is None and pool.used_blocks == 3
    b = pool.alloc(1)
    assert not pool.can_alloc(1)
    pool.free(a)
    with pytest.raises(ValueError, match="double free"):
        pool.free([a[0]])
    with pytest.raises(ValueError, match="invalid block"):
        pool.free([0])
    pool.free(b)
    assert [pool.blocks_for(n) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]
    with pytest.raises(ValueError, match="multiple of 8"):
        tpool.KVBlockPool(4, 12)
    # the same LIFO order as the JAX pool
    jp, tp = jpool.KVBlockPool(6, 8), tpool.KVBlockPool(6, 8)
    x, y = jp.alloc(4), tp.alloc(4)
    jp.free(x[1:3])
    tp.free(y[1:3])
    assert jp.alloc(3) == tp.alloc(3)


@pytest.mark.parametrize("max_seq,want", [(96, 32), (128, 128), (64, 64),
                                          (1024, 128), (100, 8), (5, 8)])
def test_pick_block_size_heuristic(max_seq, want):
    """The 128-column heuristic of the JAX pool, its default where nothing
    is measured (the CPU)."""
    assert tpool.pick_block_size(max_seq, 12, 64, device="cpu") == want


def test_pick_block_size_flag():
    from paddle_tpu_torch.core import flags
    flags.set_flags({"FLAGS_serve_block_size": 24})
    try:
        assert tpool.pick_block_size(128, 12, 64) == 24
        flags.set_flags({"FLAGS_serve_block_size": 12})
        with pytest.raises(ValueError, match="multiple of 8"):
            tpool.pick_block_size(128, 12, 64)
    finally:
        flags.set_flags({"FLAGS_serve_block_size": 0})


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 2, 1, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_decode_attention(q, torch.zeros(3, 2, 12, 8),
                               torch.zeros(3, 2, 12, 8),
                               torch.zeros(1, 2, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not match"):
        decode_attention(q, torch.zeros(1, 3, 16, 8),
                         torch.zeros(1, 3, 16, 8), 0)
    with pytest.raises(ValueError, match="exceeds"):
        decode_attention(q, torch.zeros(1, 2, 16, 8),
                         torch.zeros(1, 2, 16, 8), 16)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(q.double(), torch.zeros(1, 2, 16, 8).double(),
                         torch.zeros(1, 2, 16, 8).double(), 0)
    with pytest.raises(ValueError, match="d <= 256"):
        decode_attention(torch.zeros(1, 1, 1, 264), torch.zeros(1, 1, 8, 264),
                         torch.zeros(1, 1, 8, 264), 0)


H100_SMS = 132


@pytest.mark.parametrize("b,h,q_tiles,cols", [
    (64, 12, 1, 96), (64, 12, 1, 1024), (1, 12, 1, 1024), (1, 12, 16, 1024),
    (1, 12, 1, 96), (2, 4, 1, 4096), (1, 4, 1, 4080), (3, 4, 5, 512),
    (1, 1, 1, 8), (1, 1, 1, 65), (7, 3, 2, 100000)])
def test_kv_splits_cover_the_capacity_once(b, h, q_tiles, cols):
    """At least one split, each whole tiles (at least one), and the splits
    cover [0, cols) exactly once, in order, none starting past the end."""
    n, span = _kv_splits(b, h, q_tiles, cols, H100_SMS)
    assert n >= 1 and span >= _TILE and span % _TILE == 0
    covered = [c for i in range(n) for c in range(i * span,
                                                  min((i + 1) * span, cols))]
    assert covered == list(range(cols))
    assert (n - 1) * span < cols


def test_kv_splits_from_shapes_only():
    """One split where the blocks already fill the card (the serve decode
    step: b64 h12, 768 blocks); several for one stream over GPT-2's full
    context; none of it from the live lengths, which the planner never
    sees (they live on the card in the serve loop)."""
    import inspect
    assert list(inspect.signature(_kv_splits).parameters) == \
        ["b", "h", "q_tiles", "cols", "n_sm"]
    assert _kv_splits(64, 12, 1, 96, H100_SMS) == (1, 128)
    assert _kv_splits(64, 12, 1, 1024, H100_SMS) == (1, 1024)
    n, span = _kv_splits(1, 12, 1, 1024, H100_SMS)
    assert n > 1 and n * span == 1024
    assert _kv_splits(1, 12, 16, 1024, H100_SMS)[0] == 1   # 192 blocks
    # the plan of a call reads shapes, dtypes and alignment, never fills
    q = torch.zeros(1, 12, 1, 64, dtype=torch.bfloat16)
    kc = torch.zeros(1, 12, 1024, 64, dtype=torch.bfloat16)
    assert _plan(q, kc, kc, 1024, H100_SMS) == (_SPLIT, n, span)


def _offset(shape, dtype, elems):
    """A contiguous tensor whose data starts ``elems`` elements into its
    storage (not 16-byte aligned for a small odd offset)."""
    n = int(np.prod(shape))
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


@pytest.mark.parametrize("dtype,s,d,want", [
    (torch.bfloat16, 1, 64, _SPLIT), (torch.float32, 1, 64, _SPLIT),
    (torch.bfloat16, 1, 40, _SPLIT), (torch.float32, 1, 256, _SPLIT),
    (torch.bfloat16, 1, 36, _SCALAR), (torch.float32, 1, 6, _SCALAR),
    (torch.bfloat16, 7, 64, _MMA), (torch.bfloat16, 1024, 128, _MMA),
    (torch.float32, 7, 64, _SCALAR), (torch.bfloat16, 64, 40, _SCALAR),
    (torch.bfloat16, 64, 256, _SCALAR)])
def test_plan_chooses_the_kernel_from_dtype_and_shape(dtype, s, d, want):
    b, h, L = 2, 3, 96
    q = torch.zeros(b, h, s, d, dtype=dtype)
    kc = torch.zeros(b, h, L, d, dtype=dtype)
    path, n, span = _plan(q, kc, kc, L, H100_SMS)
    assert path == want
    assert n * span >= L and (n - 1) * span < L
    if want != _SCALAR:
        # a cache that is not 16-byte aligned takes the scalar kernel
        odd = _offset((b, h, L, d), dtype, 1)
        assert _plan(q, odd, odd, L, H100_SMS)[0] == _SCALAR
    if want == _MMA:
        assert _plan(_offset(q.shape, dtype, 1), kc, kc, L,
                     H100_SMS)[0] == _SCALAR
        assert _plan(q.float(), kc, kc, L, H100_SMS)[0] == _SCALAR


def test_cpu_calls_count_no_launch_of_any_variant():
    """bf16 CPU tensors at the Hopper kernels' shapes run the plain
    versions: no launch of any decode kernel is counted."""
    from paddle_tpu_torch.ops import cuda as kernels
    rng = np.random.RandomState(9)
    q, kc, vc = (torch.from_numpy(rng.randn(*sh).astype(np.float32))
                 .to(torch.bfloat16) for sh in ((2, 3, 5, 64),
                                                (2, 3, 32, 64),
                                                (2, 3, 32, 64)))
    kernels.reset_launch_counts()
    for s in (1, 5):
        out = decode_attention(q[:, :, :s].contiguous(), kc, vc, 3)
        assert torch.equal(out, decode_attention_ref(q[:, :, :s], kc, vc, 3))
    counts = kernels.launch_counts()
    for name in ("decode_attention", "paged_decode_attention"):
        assert counts[name] == counts[name + ".sm90"] == \
            counts[name + ".mma"] == 0
