"""Decode attention over a KV cache: the two CUDA kernels of the serving
path, their wrappers and their plain PyTorch versions.

- ``decode_attention`` replaces paddle_tpu/ops/pallas/decode_attention.py
  ``_decode_attn_kernel``: a query chunk over a contiguous cache
  [b, h, L, d] (``GPT.generate``'s StaticKVCache).
- ``paged_decode_attention`` replaces ``_paged_decode_attn_kernel``: the
  same attention over a shared arena [n_blocks + 1, h, bs, d] through
  block tables [b, nb] (the ServeLoop's paged pool).

Row r of batch row i attends to cache columns ``<= fill_i + r``, where
``fill`` counts the tokens in the cache before the chunk (the chunk's own
k/v are already written). For a CUDA tensor a wrapper launches its kernel
(csrc/decode_attention.cu) or raises; only for CPU tensors does it run
the plain version. Each wrapper counts its launches in ``.launches``.

Three kernels per wrapper, one per call, chosen by ``_path`` before the
launch from dtype, shape and alignment (a launch that fails raises; it
never gives way to another kernel):

- s = 1 with ``d * sizeof(cache)`` a multiple of 16 bytes and a 16-byte
  aligned cache: the split-K decode kernel (16-byte vector loads);
- s > 1 with q and cache both bf16 or both f16, at head dim 64 or 128,
  16-byte aligned: the mma.sync chunk kernel;
- everything else: the scalar kernel.

q and the cache may each be f32, bf16 or f16, as in the JAX kernels: q
is cast to the cache's dtype on load, and the output comes back in q's
dtype. The first two are the Hopper kernels, counted also in
``.launches_sm90`` (the chunk kernel's share in ``.launches_mma``); a
launch with q or the cache in f16 counts also in ``.launches_f16``.
Both split the cache's
capacity columns (L, or nb * bs) into ``_kv_splits`` spans, planned from
the shapes alone (never from the fills, which live on the card), and a
combine kernel merges the splits' f32 partials in order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["decode_attention", "paged_decode_attention",
           "decode_attention_ref", "paged_attention_ref", "supported"]

NEG_INF = -1e9   # finite mask fill, as the reference
_MAX_D = 256
_SUPPORTED = (torch.float32, torch.bfloat16, torch.float16)
# the C entries' dtype codes (csrc: Dtype)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 64       # columns of a split-K tile: a split is whole tiles
_SCALAR, _SPLIT, _MMA = 0, 1, 2   # kernel paths (csrc: Path)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# scale, q_dtype, cache_dtype, path, splits, span, part, stream
_TAIL = [_F, _I, _I, _I, _I, _I, _P, _P]
_SIGS = {
    "decode_attention_contiguous": [_P] * 5 + [_I] * 6 + _TAIL,
    "decode_attention_paged": [_P] * 6 + [_I] * 6 + _TAIL,
}


def _fn(name):
    from ._build import load
    f = getattr(load("decode_attention"), name)
    if f.argtypes is None:
        f.argtypes = _SIGS[name]
        f.restype = ctypes.c_int
    return f


def _kv_splits(b, h, q_tiles, cols, n_sm):
    """(number of splits, columns per split) of a cache with ``cols``
    capacity columns for b * h * q_tiles blocks on ``n_sm`` SMs. One split
    when the blocks fill the card; else about two blocks per SM, each split
    whole ``_TILE``-column tiles, the splits covering [0, cols) once. From
    the shapes alone: the live lengths are never read. (Splitting a
    1024-token prefill's 192 blocks further was slower on the H100:
    PERF.md.)"""
    tiles = -(-cols // _TILE)
    blocks = b * h * q_tiles
    n = 1 if blocks >= n_sm else max(1, min(tiles, -(-2 * n_sm // blocks)))
    per = -(-tiles // n)
    return -(-tiles // per), per * _TILE


def _path(q, k, v):
    """Which kernel takes a call: the split-K decode kernel for s = 1 with
    16-byte rows and a 16-byte aligned cache, the mma chunk kernel for
    bf16 or f16 chunks (q and cache alike) at d 64 / 128 with 16-byte
    aligned q and cache, else the scalar kernel."""
    s, d = q.shape[2], q.shape[3]
    aligned = all(t.data_ptr() % 16 == 0 for t in (k, v))
    if s == 1:
        return _SPLIT if aligned and d * k.element_size() % 16 == 0 \
            else _SCALAR
    if q.dtype == k.dtype and q.dtype != torch.float32 and \
            d in (64, 128) and aligned and q.data_ptr() % 16 == 0:
        return _MMA
    return _SCALAR


def _plan(q, k, v, cols, n_sm):
    """(path, splits, columns per split) of a call over a cache of ``cols``
    capacity columns: the scalar kernel takes one split over them all."""
    b, h, s, _ = q.shape
    path = _path(q, k, v)
    if path == _SCALAR:
        return path, 1, -(-cols // _TILE) * _TILE
    return (path, *_kv_splits(b, h, -(-s // 64), cols, n_sm))


@functools.lru_cache(maxsize=None)
def _n_sm(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# --------------------------------------------------------------------------
# plain versions: the CPU path and the oracle on the card
# --------------------------------------------------------------------------

def _fill_vector(fill, b, device):
    """A fill given as an int, a 0-d or a [b] tensor -> int64 [b]."""
    return torch.as_tensor(fill, device=device).to(torch.int64) \
        .reshape(-1).expand(b)


def decode_attention_ref(q, kc, vc, index, scale=None):
    """Attention of q [b, h, s, d] over a cache kc/vc [b, h, L, d]; row r
    attends to cols <= index + r (``index`` an int or a [b] vector).
    Semantics of paddle_tpu's ``_static_cache_attention``: scores in f32
    with q cast to the cache dtype, masked to -1e9, softmax in f32.
    Returns [b, h, s, d] in q's dtype."""
    b, h, s, d = q.shape
    L = kc.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    fill = _fill_vector(index, b, q.device)
    row = fill[:, None] + torch.arange(s, device=q.device)[None]    # [b, s]
    col = torch.arange(L, device=q.device)
    live = col[None, None, :] <= row[:, :, None]                    # [b, s, L]
    qc = q.to(kc.dtype).float()
    scores = torch.einsum("bhsd,bhld->bhsl", qc, kc.float()) * scale
    scores = scores.masked_fill(~live[:, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhsl,bhld->bhsd", p, vc.float())
    return out.to(q.dtype)


def gather_pages(arena, block_tables):
    """[n_blocks + 1, h, bs, d] arena through [b, nb] tables -> the
    contiguous logical view [b, h, nb * bs, d]."""
    b, nb = block_tables.shape
    _, h, bs, d = arena.shape
    g = arena[block_tables.long()]                    # [b, nb, h, bs, d]
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, nb * bs, d)


def paged_attention_ref(q, k_arena, v_arena, block_tables, lengths,
                        scale=None):
    """Paged attention by gathering each row's blocks into a contiguous
    view and running ``decode_attention_ref`` with per-row fills
    (paddle_tpu/nn/kv_pool.py ``paged_attention_ref``)."""
    return decode_attention_ref(q, gather_pages(k_arena, block_tables),
                                gather_pages(v_arena, block_tables),
                                lengths, scale)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def supported(q_shape, cache_shape) -> bool:
    """The JAX kernel's shape gate (paddle_tpu/ops/pallas/
    decode_attention.py ``supported``): q [b, h, s, d] against a cache
    [b, h, L, d] with d <= 256, 1 <= s <= 256 and L >= 8."""
    if len(q_shape) != 4 or len(cache_shape) != 4:
        return False
    b, h, s, d = q_shape
    bl, hl, L, dl = cache_shape
    return (bl, hl, dl) == (b, h, d) and d <= _MAX_D and 1 <= s <= 256 \
        and L >= 8


def _check_common(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and the cache must be 4-D, got "
                         f"q{tuple(q.shape)} k{tuple(k.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k{tuple(k.shape)} and v{tuple(v.shape)} "
                         "differ")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype not in _SUPPORTED:
            raise TypeError(f"{name}: dtype {t.dtype} not in {_SUPPORTED}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if k.dtype != v.dtype:
        raise TypeError(f"{name}: k {k.dtype} and v {v.dtype} differ")
    b, h, s, d = q.shape
    if d > _MAX_D or s < 1 or b < 1 or h < 1:
        raise ValueError(f"{name}: q{tuple(q.shape)} needs 1 <= s, "
                         f"d <= {_MAX_D}")
    if k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"{name}: cache {tuple(k.shape)} does not match "
                         f"q{tuple(q.shape)}")


def _int_vector(name, t, b, device):
    """A [b] int32 fill tensor on the card (a 0-d one is broadcast)."""
    if not isinstance(t, torch.Tensor) or t.dtype not in (torch.int32,
                                                         torch.int64):
        raise TypeError(f"{name}: fill must be an int or an integer tensor")
    if t.device != device:
        raise ValueError(f"{name}: fill on {t.device}, q on {device}")
    if t.dim() == 0:
        t = t.reshape(1).expand(b)
    if t.shape != (b,):
        raise ValueError(f"{name}: fill shape {tuple(t.shape)} != ({b},)")
    return t.to(torch.int32).contiguous()


def _check_status(name, status):
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")


def _launch(wrapper, entry, q, k, v, cols, head_args, scale):
    """Plan the path and the splits, launch, count. ``head_args`` are the
    C arguments between ``out`` and ``scale``; ``cols`` the cache's
    capacity in columns."""
    b, h, s, d = q.shape
    path, splits, span = _plan(q, k, v, cols, _n_sm(q.device.index))
    out = torch.empty_like(q)
    part = None if splits == 1 else torch.empty(
        splits * b * h * s * (d + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = _fn(entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *head_args, scale, _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k.dtype], path, splits, span,
            None if part is None else part.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _check_status(wrapper.__name__, status)
    wrapper.launches += 1
    wrapper.launches_sm90 += path != _SCALAR
    wrapper.launches_mma += path == _MMA
    wrapper.launches_f16 += torch.float16 in (q.dtype, k.dtype)
    return out


def decode_attention(q, kc, vc, index, scale=None):
    """Attention of q [b, h, s, d] over a contiguous cache kc/vc
    [b, h, L, d]. ``index`` is the cache fill before this chunk: an int or
    an integer tensor, scalar or [b]. Row r attends to cols <= index + r.
    Returns [b, h, s, d] in q's dtype. CUDA tensors launch the kernel;
    CPU tensors run ``decode_attention_ref``."""
    name = "decode_attention"
    _check_common(name, q, kc, vc)
    b, h, s, d = q.shape
    if kc.shape[0] != b:
        raise ValueError(f"{name}: cache batch {kc.shape[0]} != {b}")
    L = kc.shape[2]
    if not isinstance(index, torch.Tensor):
        index = int(index)
    if isinstance(index, int) and not 0 <= index <= L - s:
        raise ValueError(f"{name}: fill {index} + chunk {s} exceeds cache "
                         f"length {L}")
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, kc, vc, index, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if isinstance(index, int):
        fills, fill_scalar = None, index
    else:
        fills, fill_scalar = _int_vector(name, index, b, q.device), 0
    return _launch(
        decode_attention, "decode_attention_contiguous", q, kc, vc, L,
        (None if fills is None else fills.data_ptr(), fill_scalar,
         b, h, s, d, L),
        scale)


def paged_decode_attention(q, k_arena, v_arena, block_tables, lengths,
                           scale=None):
    """Attention of q [b, h, s, d] over a paged cache: arenas
    [n_blocks + 1, h, bs, d] (row 0 the trash block), block tables
    [b, nb] int32 of physical rows (entries past a row's allocation are
    0), ``lengths`` [b] int32 fills before the chunk. Row r of batch row
    i attends to logical cols <= lengths[i] + r. CUDA tensors launch the
    kernel; CPU tensors run ``paged_attention_ref``."""
    name = "paged_decode_attention"
    _check_common(name, q, k_arena, v_arena)
    b, h, s, d = q.shape
    bs = k_arena.shape[2]
    if bs < 8 or bs % 8 != 0:
        raise ValueError(f"{name}: block size {bs} must be a multiple of 8")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block tables {tuple(block_tables.shape)}"
                         f" do not match batch {b}")
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_arena, v_arena, block_tables,
                                   lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if block_tables.dtype != torch.int32 or not block_tables.is_contiguous() \
            or block_tables.device != q.device:
        raise ValueError(f"{name}: block tables must be contiguous int32 on "
                         f"{q.device}")
    fills = _int_vector(name, lengths, b, q.device)
    nb = block_tables.shape[1]
    return _launch(
        paged_decode_attention, "decode_attention_paged", q, k_arena,
        v_arena, nb * bs,
        (fills.data_ptr(), block_tables.data_ptr(), b, h, s, d, bs, nb),
        scale)


for _w in (decode_attention, paged_decode_attention):
    _w.launches = _w.launches_sm90 = _w.launches_mma = _w.launches_f16 = 0
