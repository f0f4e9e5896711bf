"""Fused linear + cross-entropy: the three CUDA kernels of the training
loss head, their wrappers, their plain PyTorch versions and the
``torch.autograd.Function`` that joins them.

- ``fused_ce_fwd`` replaces paddle_tpu/ops/pallas/fused_ce.py
  ``_ce_fwd_kernel``: per-token ``lse(h W^T + b) - logit[y]`` and lse,
  without the [n, V] logits.
- ``fused_ce_bwd_dh`` replaces ``_ce_bwd_dh_kernel``: dh from the saved
  lse, recomputing each logits tile.
- ``fused_ce_bwd_dw`` replaces ``_ce_bwd_dw_kernel``: dW and db.

Contract (the TPU kernel's): rows with ``y == ignore_index`` give loss 0
and no gradient; lse is ``m + log(max(l, 1e-30))``; a label outside
[0, V) that is not ``ignore_index`` matches no column (loss = lse). The
JAX wrapper pads W to a multiple of 128 rows; the CUDA kernels mask the
ragged vocab tile instead, so nothing is padded or sliced here. The
backward kernels work on the list of valid rows only (an ignored row's
gradient terms are zero); ``valid_rows`` builds it on the card, once per
backward when the caller passes it to both.

For a CUDA tensor a wrapper launches its kernel or raises; only for CPU
tensors does it run the plain version. Each wrapper counts its launches in
``.launches``.

The forward has two kernels: bf16 or f16 with H a multiple of 64 runs the
Hopper forward of csrc/fused_ce_sm90.cu (the backward's wgmma GEMM main loop with
an online-softmax epilogue, the vocab split in ranges merged in order),
counted also in ``fused_ce_fwd.launches_sm90``; f32 and other H run
csrc/fused_ce.cu's. ``_sm90_fwd_path`` makes that choice before launch.

The backward has two kernels. ``fused_ce_bwd`` computes dh, dW and db
together; bf16 or f16 with H a multiple of 64 (at most 1024) runs the
Hopper backward of csrc/fused_ce_sm90.cu, which shares one recompute of the
logits between dh and dW (wgmma GEMM tiles with register accumulators, over
vocab chunks: ``vocab_chunks``), counted also in ``.launches_sm90`` of
``fused_ce_bwd_dh`` / ``fused_ce_bwd_dw``; f32 and other H run the dh and
dW kernels of csrc/fused_ce.cu. ``_sm90_bwd_path`` makes that choice before
launch; a launch that fails raises and never gives way to the other
kernel. ``fused_ce_bwd_dh`` and ``fused_ce_bwd_dw`` are ``fused_ce_bwd``
asked for one gradient each.

Both sources take f16 as they take bf16 (templates on the 16-bit type);
each wrapper's f16 launches are counted also in ``.launches_f16``.
"""
from __future__ import annotations

import ctypes

import torch
from ...core.flop_count import kernel_flops
from ._autograd import first_order_only

__all__ = ["fused_ce", "fused_ce_fwd", "fused_ce_bwd", "fused_ce_bwd_dh",
           "fused_ce_bwd_dw", "fused_ce_fwd_ref", "fused_ce_bwd_ref",
           "valid_rows", "vocab_chunk", "vocab_chunks"]

_MAX_H = 1024
_SUPPORTED = (torch.float32, torch.bfloat16, torch.float16)
_SM90_DTYPES = (torch.bfloat16, torch.float16)
_FWD_TOKENS = 64          # token rows per forward block (csrc kFwdTM)
_DH_TOKENS = 32           # listed rows per dh block (csrc kDhTM)
_VOCAB_TILE = 64          # vocab columns per fwd / dh tile (csrc kFwdTV)
_MAX_DH_SPLITS = 16
_GEMM_TILE = 128          # Hopper backward's block tile (csrc kBM, kBN)
# ds chunk of the Hopper backward: at most n x Vc = 2**25 bf16 elements
# (64 MB, two such buffers), the fastest of 2**23 .. 2**26 at GPT-2's head
# on the H100 (chip_smoke.phase_ce_chunk_sweep, PERF.md): wider chunks mean
# fewer dh partial-sum passes, and ds staying in L2 mattered less
_CHUNK_ELEMS = 1 << 25

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "fused_ce_fwd": [_P] * 7 + [_I] * 6 + [_P],
    "fused_ce_bwd_dh": [_P] * 10 + [_I] * 6 + [_P],
    "fused_ce_bwd_dw": [_P] * 10 + [_I] * 5 + [_P],
    "fused_ce_valid_rows": [_P] * 3 + [_I] * 2 + [_P],
    "fused_ce_sm90_bwd": [_P] * 20 + [_I] * 6 + [_P],
    "fused_ce_sm90_fwd": [_P] * 7 + [_I] * 6 + [_P],
}


def _dtype_code(dtype):
    from ._build import DTYPE_CODE
    return DTYPE_CODE[str(dtype)]


def _fn(name):
    from ._build import load
    lib = "fused_ce_sm90" if name.startswith("fused_ce_sm90") else "fused_ce"
    f = getattr(load(lib), name)
    if f.argtypes is None:
        f.argtypes = _SIGS[name]
        f.restype = ctypes.c_int
    return f


# --------------------------------------------------------------------------
# plain versions: the CPU path and the oracle on the card
# --------------------------------------------------------------------------

def _logits_ref(h, w, b):
    """f32 logits [n, V] from the inputs upcast to f32 (the kernels
    accumulate in f32 and never round the logits)."""
    s = h.float() @ w.float().T
    return s if b is None else s + b.float()


def _label_hits(y, vocab):
    """(labels inside [0, vocab), the labels made safe to gather)."""
    y = y.long()
    in_range = (y >= 0) & (y < vocab)
    return in_range, torch.where(in_range, y, torch.zeros_like(y))


def fused_ce_fwd_ref(h, w, b, y, ignore_index=-100):
    """Per-token loss and lse (both f32 [n]) of ``h @ w.T + b`` against
    ``y``: the semantics of paddle_tpu's ``_ce_head_fallback``, plus the
    lse. Loss is 0 where ``y == ignore_index``; an out-of-range label
    matches no column, so its loss is lse."""
    s = _logits_ref(h, w, b)
    lse = torch.logsumexp(s, dim=-1)
    in_range, safe = _label_hits(y, w.shape[0])
    tgt = torch.where(in_range, s.gather(1, safe[:, None])[:, 0],
                      torch.zeros_like(lse))
    loss = torch.where(y.long() != ignore_index, lse - tgt,
                       torch.zeros_like(lse))
    return loss, lse


def _ds_ref(h, w, b, y, lse, g, ignore_index):
    """dlogits [n, V] f32: (softmax - onehot(y)) * g, 0 on ignored rows
    (paddle_tpu ``_ds_tile``)."""
    s = _logits_ref(h, w, b)
    p = torch.exp(s - lse.float()[:, None])
    in_range, safe = _label_hits(y, w.shape[0])
    onehot = torch.zeros_like(p)
    onehot.scatter_(1, safe[:, None], in_range.float()[:, None])
    gv = torch.where(y.long() != ignore_index, g.float(),
                     torch.zeros_like(lse, dtype=torch.float32))
    return (p - onehot) * gv[:, None]


def fused_ce_bwd_ref(h, w, b, y, lse, g, ignore_index=-100, need_dh=True,
                     need_dw=True):
    """(dh, dW, db) of the per-token losses against upstream ``g`` [n],
    recomputed from the saved lse. ds is rounded to W's dtype for dh and
    to h's dtype for dW, as the kernels do; products accumulate in f32.
    Entries not asked for (or db without a bias) are None."""
    ds = _ds_ref(h, w, b, y, lse, g, ignore_index)
    dh = dw = db = None
    if need_dh:
        dh = (ds.to(w.dtype).float() @ w.float()).to(h.dtype)
    if need_dw:
        dw = (ds.to(h.dtype).float().T @ h.float()).to(w.dtype)
        if b is not None:
            db = ds.sum(0).to(b.dtype)
    return dh, dw, db


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(name, h, w, b, y, *f32_rows):
    """Shapes and types every kernel takes; returns (n, H, V)."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: need h [n, H] and w [V, H], got "
                         f"h{tuple(h.shape)} w{tuple(w.shape)}")
    n, hd = h.shape
    vocab = w.shape[0]
    if n < 1 or vocab < 1:
        raise ValueError(f"{name}: empty input h{tuple(h.shape)} "
                         f"w{tuple(w.shape)}")
    if y.shape != (n,):
        raise ValueError(f"{name}: labels {tuple(y.shape)} != ({n},)")
    if y.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: labels must be int32 or int64")
    if b is not None and b.shape != (vocab,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} != ({vocab},)")
    tensors = [h, w, y] + ([b] if b is not None else []) + list(f32_rows)
    for t in tensors:
        if t.device != h.device:
            raise ValueError(f"{name}: tensors on {t.device} and {h.device}")
    for t in f32_rows:
        if t.shape != (n,):
            raise ValueError(f"{name}: per-token input {tuple(t.shape)} "
                             f"!= ({n},)")
    if h.device.type == "cpu":
        return n, hd, vocab
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    if h.dtype not in _SUPPORTED:
        raise TypeError(f"{name}: dtype {h.dtype} not in {_SUPPORTED}")
    for t in (w,) + ((b,) if b is not None else ()):
        if t.dtype != h.dtype:
            raise TypeError(f"{name}: h is {h.dtype} but a weight is "
                            f"{t.dtype}")
    for t in (h, w) + ((b,) if b is not None else ()):
        if not t.is_contiguous():
            raise ValueError(f"{name}: h, w and b must be contiguous")
    for t in f32_rows:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: lse and g must be contiguous f32")
    if hd % 8 != 0 or hd > _MAX_H:
        raise ValueError(f"{name}: hidden size {hd} must be a multiple of "
                         f"8 and at most {_MAX_H}")
    return n, hd, vocab


def _check_status(name, status):
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _vocab_splits(device, tiles, vocab, per_sm, cap=None):
    """Vocab ranges per token tile: enough (tile, range) blocks for
    ``per_sm`` per SM when every tile is busy, at most ``cap`` and never
    more ranges than vocab tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    vtiles = -(-vocab // _VOCAB_TILE)
    return max(1, min(vtiles, cap or vtiles, -(-per_sm * sms // tiles)))


def valid_rows(y, ignore_index=-100):
    """The backward kernels' list of the rows of CUDA labels ``y [n]``
    that are not ``ignore_index``, built on the card: (rows int32 [n + 1],
    in order with the count last; pos int32 [n], each row's place in the
    list or -1)."""
    name = "fused_ce_valid_rows"
    if y.device.type != "cuda" or y.dim() != 1 or y.shape[0] < 1:
        raise ValueError(f"{name}: need CUDA labels [n], got "
                         f"{tuple(y.shape)} on {y.device}")
    n = y.shape[0]
    y32 = y.to(torch.int32).contiguous()
    rows = torch.empty(n + 1, dtype=torch.int32, device=y.device)
    pos = torch.empty(n, dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        status = _fn(name)(y32.data_ptr(), rows.data_ptr(), pos.data_ptr(),
                           n, int(ignore_index),
                           torch.cuda.current_stream(y.device).cuda_stream)
    _check_status(name, status)
    return rows, pos


def _sm90_fwd_path(dtype, hd) -> bool:
    """Does a forward take the Hopper kernel of csrc/fused_ce_sm90.cu? bf16
    or f16 with H a multiple of 64 (its K step) does; f32 and other H take
    csrc/fused_ce.cu's forward. The cap of 1024 is every CE wrapper's
    (``_check``), not the Hopper kernel's."""
    return dtype in _SM90_DTYPES and hd % 64 == 0 and 64 <= hd <= _MAX_H


def _fwd_sm90_splits(device, n, vocab):
    """Vocab ranges of the Hopper forward: as many as let its 128-row tiles
    fill the card's 2 blocks per SM in one wave (8 for n 4096 on 132 SMs),
    never more than the vocab tiles and at least one."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_tiles = -(-n // _GEMM_TILE)
    return max(1, min(-(-vocab // _GEMM_TILE), 2 * sms // row_tiles))


def _fwd_flops(h, w, b, *args, **kwargs):
    """The logits' product; the bias, the log-sum-exp (3 a logit) and the
    label term (``core/flop_count.py``)."""
    n, vocab = h.shape[0], w.shape[0]
    return 2 * n * h.shape[1] * vocab, \
        (3 + (b is not None)) * n * vocab + 2 * n


def _bwd_flops(h, w, b, y, lse, g, ignore_index=-100, need_dh=True,
               need_dw=True, rows=None):
    """The logits recomputed, then dh = dS·W and dW = dSᵀ·h as asked; the
    softmax and dS 4 a logit, db 1."""
    n, hd, vocab = h.shape[0], h.shape[1], w.shape[0]
    mm = 2 * n * hd * vocab * (1 + bool(need_dh) + bool(need_dw))
    return mm, (4 + (b is not None and bool(need_dw))) * n * vocab


@kernel_flops(_fwd_flops)
def fused_ce_fwd(h, w, b, y, ignore_index=-100):
    """Per-token loss and lse, both f32 [n], of ``h [n, H] @ w[V, H].T +
    b [V]`` (b may be None) against labels ``y [n]``. CUDA tensors launch
    the kernel (bf16 or f16 with H a multiple of 64 the Hopper forward, the
    csrc/fused_ce.cu's); CPU tensors run ``fused_ce_fwd_ref``."""
    name = "fused_ce_fwd"
    n, hd, vocab = _check(name, h, w, b, y)
    if h.device.type == "cpu":
        return fused_ce_fwd_ref(h, w, b, y, ignore_index)
    y32 = y.to(torch.int32).contiguous()
    sm90 = _sm90_fwd_path(h.dtype, hd)
    if sm90:
        h, w = _aligned16(h), _aligned16(w)
        entry = "fused_ce_sm90_fwd"
        splits = _fwd_sm90_splits(h.device, n, vocab)
    else:
        entry = name
        splits = _vocab_splits(h.device, -(-n // _FWD_TOKENS), vocab, 2)
    loss = torch.empty(n, dtype=torch.float32, device=h.device)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    part = torch.empty(3, splits, n, dtype=torch.float32, device=h.device)
    args = [h.data_ptr(), w.data_ptr(), _ptr(b), y32.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), part.data_ptr(), n, hd, vocab,
            int(ignore_index), splits, _dtype_code(h.dtype)]
    with torch.cuda.device(h.device):
        status = _fn(entry)(*args,
                            torch.cuda.current_stream(h.device).cuda_stream)
    _check_status(name, status)
    fused_ce_fwd.launches += 1
    fused_ce_fwd.launches_sm90 += sm90
    fused_ce_fwd.launches_f16 += h.dtype == torch.float16
    return loss, lse


def _sm90_bwd_path(dtype, hd) -> bool:
    """Does a backward take the Hopper kernels of csrc/fused_ce_sm90.cu?
    bf16 or f16 with H a multiple of 64 up to 1024 does; f32 and other H
    take the dh and dW kernels of csrc/fused_ce.cu."""
    return dtype in _SM90_DTYPES and hd % 64 == 0 and 64 <= hd <= _MAX_H


def vocab_chunk(n, vocab):
    """Vocab columns per ds chunk of the Hopper backward for n rows: as few
    chunks as keep n x Vc <= ``_CHUNK_ELEMS`` (Vc at least 128), then the
    narrowest multiple of 128 that covers the vocab in that many, so the
    chunks are near equal."""
    fit = max(_GEMM_TILE, _CHUNK_ELEMS // n // _GEMM_TILE * _GEMM_TILE)
    chunks = -(-vocab // fit)
    return -(-vocab // (chunks * _GEMM_TILE)) * _GEMM_TILE


def vocab_chunks(vocab, chunk):
    """The chunk schedule: (first column, width) of each chunk in order,
    covering [0, vocab) once; every chunk but the last is ``chunk`` wide."""
    return [(v0, min(chunk, vocab - v0)) for v0 in range(0, vocab, chunk)]


def _aligned16(t):
    """t, or a copy of it where its data is not 16-byte aligned (the
    Hopper kernels read rows in 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _bwd_sm90(h, w, b, y32, lse, g, rows, pos, need_dh, need_dw):
    name = "fused_ce_sm90_bwd"
    n, hd = h.shape
    vocab = w.shape[0]
    h, w = _aligned16(h), _aligned16(w)
    chunk = vocab_chunk(n, vocab)
    sched = vocab_chunks(vocab, chunk)
    starts = (ctypes.c_int * len(sched))(*(s for s, _ in sched))
    widths = (ctypes.c_int * len(sched))(*(c for _, c in sched))
    row_tiles = -(-n // _GEMM_TILE)
    dev, f32 = h.device, torch.float32
    want_db = need_dw and b is not None
    hc = torch.empty(n, hd, dtype=h.dtype, device=dev)
    lse_c = torch.empty(n, dtype=f32, device=dev)
    g_c = torch.empty(n, dtype=f32, device=dev)
    y_c = torch.empty(n, dtype=torch.int32, device=dev)
    # two ds buffers: the launch that forms chunk c's ds runs chunk c - 1's
    # dh and dW passes
    bufs = min(2, len(sched))
    ds = torch.empty(bufs, n, chunk, dtype=h.dtype, device=dev)
    dbp = torch.empty(bufs, row_tiles, chunk, dtype=f32, device=dev) \
        if want_db else None
    part = torch.empty(row_tiles * _GEMM_TILE, hd, dtype=f32, device=dev) \
        if need_dh else None
    dh = torch.empty_like(h) if need_dh else None
    dw = torch.empty_like(w) if need_dw else None
    db = torch.empty_like(b) if want_db else None
    with torch.cuda.device(dev):
        status = _fn(name)(
            h.data_ptr(), w.data_ptr(), _ptr(b), y32.data_ptr(),
            lse.data_ptr(), g.data_ptr(), rows.data_ptr(), pos.data_ptr(),
            hc.data_ptr(), lse_c.data_ptr(), g_c.data_ptr(), y_c.data_ptr(),
            ds.data_ptr(), _ptr(dbp), _ptr(part), _ptr(dh), _ptr(dw),
            _ptr(db), starts, widths, len(sched), n, hd, vocab, chunk,
            _dtype_code(h.dtype), torch.cuda.current_stream(dev).cuda_stream)
    _check_status(name, status)
    return dh, dw, db


def _bwd_dh(h, w, b, y32, lse, g, rows, pos, ignore_index):
    """dh through csrc/fused_ce.cu's dh kernel."""
    name = "fused_ce_bwd_dh"
    n, hd = h.shape
    dh = torch.empty_like(h)
    # the vocab split keeps the card busy when few rows are valid: sized
    # for 8 blocks per SM if every row were, so 1 in 8 valid still fills it
    splits = _vocab_splits(h.device, -(-n // _DH_TOKENS), w.shape[0], 8,
                           _MAX_DH_SPLITS)
    part = torch.empty(splits, n, hd, dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        status = _fn(name)(
            h.data_ptr(), w.data_ptr(), _ptr(b), y32.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dh.data_ptr(), rows.data_ptr(),
            pos.data_ptr(), part.data_ptr(), n, hd, w.shape[0],
            int(ignore_index), splits, _dtype_code(h.dtype),
            torch.cuda.current_stream(h.device).cuda_stream)
    _check_status(name, status)
    return dh


def _bwd_dw(h, w, b, y32, lse, g, rows, pos, ignore_index):
    """(dW, db) through csrc/fused_ce.cu's dW kernel."""
    name = "fused_ce_bwd_dw"
    n, hd = h.shape
    dw = torch.empty_like(w)
    db = None if b is None else torch.empty_like(b)
    with torch.cuda.device(h.device):
        status = _fn(name)(
            h.data_ptr(), w.data_ptr(), _ptr(b), y32.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dw.data_ptr(), _ptr(db),
            rows.data_ptr(), pos.data_ptr(), n, hd, w.shape[0],
            int(ignore_index), _dtype_code(h.dtype),
            torch.cuda.current_stream(h.device).cuda_stream)
    _check_status(name, status)
    return dw, db


@kernel_flops(_bwd_flops)
def fused_ce_bwd(h, w, b, y, lse, g, ignore_index=-100, need_dh=True,
                 need_dw=True, rows=None):
    """(dh [n, H] in h's dtype, dW [V, H] in w's dtype, db [V] in b's
    dtype) from the saved lse [n] and the upstream gradient ``g`` [n] of
    the per-token losses; None for what is not asked (db also without a
    bias). CUDA tensors launch the kernels over ``rows``
    (``valid_rows(y)``, built here when None): bf16 or f16 with H a
    multiple of 64 the Hopper backward, one recompute of the logits for both
    gradients; the rest csrc/fused_ce.cu's dh and dW kernels. CPU tensors
    run ``fused_ce_bwd_ref``."""
    name = "fused_ce_bwd"
    n, hd, vocab = _check(name, h, w, b, y, lse, g)
    if h.device.type == "cpu":
        return fused_ce_bwd_ref(h, w, b, y, lse, g, ignore_index, need_dh,
                                need_dw)
    if not (need_dh or need_dw):
        return None, None, None
    y32 = y.to(torch.int32).contiguous()
    rows, pos = rows or valid_rows(y32, ignore_index)
    sm90 = _sm90_bwd_path(h.dtype, hd)
    if sm90:
        dh, dw, db = _bwd_sm90(h, w, b, y32, lse, g, rows, pos, need_dh,
                               need_dw)
    else:
        dh = _bwd_dh(h, w, b, y32, lse, g, rows, pos, ignore_index) \
            if need_dh else None
        dw, db = _bwd_dw(h, w, b, y32, lse, g, rows, pos, ignore_index) \
            if need_dw else (None, None)
    for wanted, counted in ((need_dh, fused_ce_bwd_dh),
                            (need_dw, fused_ce_bwd_dw)):
        if wanted:
            counted.launches += 1
            counted.launches_sm90 += sm90
            counted.launches_f16 += h.dtype == torch.float16
    return dh, dw, db


def fused_ce_bwd_dh(h, w, b, y, lse, g, ignore_index=-100, rows=None):
    """dh [n, H] in h's dtype: ``fused_ce_bwd`` asked for dh alone."""
    return fused_ce_bwd(h, w, b, y, lse, g, ignore_index, need_dw=False,
                        rows=rows)[0]


def fused_ce_bwd_dw(h, w, b, y, lse, g, ignore_index=-100, rows=None):
    """(dW [V, H] in w's dtype, db [V] in b's dtype or None without a
    bias): ``fused_ce_bwd`` asked for dW alone."""
    return fused_ce_bwd(h, w, b, y, lse, g, ignore_index, need_dh=False,
                        rows=rows)[1:]


for _w in (fused_ce_fwd, fused_ce_bwd_dh, fused_ce_bwd_dw):
    _w.launches = _w.launches_sm90 = _w.launches_f16 = 0


class _FusedCE(torch.autograd.Function):
    """Per-token losses with the kernels' backward: saves (h, W, b, y,
    lse) and recomputes the logits in ``fused_ce_bwd``, once for every
    gradient asked for. First order only, as the flash Function."""

    @staticmethod
    def forward(ctx, h, w, b, y, ignore_index):
        loss, lse = fused_ce_fwd(h, w, b, y, ignore_index)
        ctx.save_for_backward(h, w, b, y, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    @first_order_only(3)
    def backward(ctx, g):
        h, w, b, y, lse = ctx.saved_tensors
        g = g.float().contiguous()
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        dh, dw, db = fused_ce_bwd(h, w, b, y, lse, g, ctx.ignore_index,
                                  need_h, need_w or need_b)
        return dh, dw if need_w else None, db if need_b else None, None, None


def fused_ce(h, w, b, y, ignore_index=-100):
    """Differentiable per-token losses f32 [n] (0 where ignored) of
    ``h [n, H] @ w.T + b`` against ``y [n]``; gradients flow to h, w and
    b through the backward kernels."""
    return _FusedCE.apply(h, w, b, y, int(ignore_index))
