"""Flash attention: the three CUDA kernels of attention training at long
sequence, their wrappers, their plain PyTorch versions and the
``torch.autograd.Function`` that joins them.

- ``flash_fwd`` replaces paddle_tpu/ops/pallas/flash_attention.py
  ``_flash_fwd_kernel``: online-softmax attention, O in the input dtype
  and the per-row lse in f32, without the [s_q, s_k] scores.
- ``flash_bwd_dq`` replaces ``_flash_bwd_dq_kernel``: dq from P recomputed
  from the saved lse and ``delta = rowsum(dO * O)``.
- ``flash_bwd_dkv`` replaces ``_flash_bwd_dkv_kernel``: dk and dv.

Contract (the TPU kernels'): scores ``(q . k^T) * scale`` in f32, then the
additive key bias [b, s_k] (f32 data, no gradient: dbias is zeros), then
the causal mask aligned bottom-right (``col <= row + s_k - s_q``); masked
entries are the finite -1e9 (``NEG_INF``). The JAX wrapper pads s to a
multiple of 8 and masks the padded keys through the bias; the CUDA kernels
take any s_q, s_k and mask the ragged tile themselves, so nothing is padded
or sliced here. Causal rows with no visible key (s_q > s_k) are outside
the contract.

Layout: the wrappers and plain versions take q [b*h, s_q, d] and k, v
[b*h, s_k, d]; ``flash_attention`` takes [b, h, s, d] as the JAX function
does. For a CUDA tensor a wrapper launches its kernel or raises; only for
CPU tensors does it run the plain version. Each wrapper counts its launches
in ``.launches``.

Two kernels per wrapper: bf16 or f16 at head dim 64 or 128 with 16-byte
aligned inputs goes to the Hopper kernels of csrc/flash_attention_sm90.cu
(register-resident mma.sync tiles, a cp.async ring), counted also in
``.launches_sm90``; everything else to csrc/flash_attention.cu. Both
sources take f16 as they take bf16 (templates on the 16-bit type); a
wrapper's f16 launches are counted also in ``.launches_f16``.
``_sm90_path`` makes that choice before launch (``_entry``), from dtype,
head dim and alignment alone, for the forward, dq and dk/dv alike; a
launch that fails raises and never gives way to the other kernel.

``torch.export`` cannot see a ctypes launch, so under export
(``torch.compiler.is_exporting()``) ``flash_attention`` calls the forward
as the custom op ``paddle_tpu_torch::flash_attention_fwd`` (CUDA: the
launch; CPU: the plain version; a fake for the shapes), which the
exported program records and its run launches; eager training keeps the
direct call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_ref", "flash_bwd_ref", "flash_delta", "supported",
           "NEG_INF"]

NEG_INF = -1e9   # finite mask fill, as the reference
_MAX_D = 256
_SUPPORTED = (torch.float32, torch.bfloat16, torch.float16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 5 + [_F] + [_I] * 3 + [_P]   # BH, H, Sq, Sk, D, scale, flags
_TAIL_SM90 = [_I] * 5 + [_F] + [_I] * 2 + [_P]   # ..., causal, dtype
_SIGS = {
    "flash_attention_fwd": [_P] * 6 + _TAIL,
    "flash_attention_bwd_dq": [_P] * 8 + _TAIL,
    "flash_attention_bwd_dkv": [_P] * 9 + _TAIL,
    "flash_sm90_fwd": [_P] * 6 + _TAIL_SM90,
    "flash_sm90_bwd_dq": [_P] * 8 + _TAIL_SM90,
    "flash_sm90_bwd_dkv": [_P] * 9 + _TAIL_SM90,
}
_SM90_D = (64, 128)
_SM90_DTYPES = (torch.bfloat16, torch.float16)


def _dtype_code(dtype):
    from ._build import DTYPE_CODE
    return DTYPE_CODE[str(dtype)]


def _fn(name):
    from ._build import load
    lib = "flash_attention_sm90" if name.startswith("flash_sm90") \
        else "flash_attention"
    f = getattr(load(lib), name)
    if f.argtypes is None:
        f.argtypes = _SIGS[name]
        f.restype = ctypes.c_int
    return f


def _sm90_path(dtype, d, aligned) -> bool:
    """Does a call take the Hopper kernels (forward, dq, dk/dv)? bf16 or
    f16 at head dim 64 or 128 with 16-byte aligned q, k, v (and dO) does;
    f32, other head dims and unaligned inputs take
    csrc/flash_attention.cu."""
    return dtype in _SM90_DTYPES and d in _SM90_D and bool(aligned)


def _aligned(tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def supported(q_shape, k_shape, v_shape, mask_shape=None) -> bool:
    """Can ``flash_attention`` take these shapes? (paddle_tpu's
    ``supported``, flash_attention.py:467-485.) 4-D q/k/v with one head
    dim d <= 256, k and v of one length, and a mask, if any, of exactly
    [b, 1, 1, s_k]. Sequence lengths are unconstrained."""
    if len(q_shape) != 4 or len(k_shape) != 4 or len(v_shape) != 4:
        return False
    b, h, sq, d = q_shape
    sk = k_shape[2]
    if d > _MAX_D or k_shape[3] != d or v_shape[3] != d or v_shape[2] != sk:
        return False
    if sq < 1 or sk < 1:
        return False
    if mask_shape is not None:
        # exactly [b, 1, 1, sk]: the kernels' bias does no broadcasting
        if tuple(mask_shape) != (b, 1, 1, sk):
            return False
    return True


# --------------------------------------------------------------------------
# plain versions: the CPU path and the oracle on the card
# --------------------------------------------------------------------------

def _scores_ref(q, k, bias, causal, scale):
    """f32 scores [bh, s_q, s_k]: ``(q . k^T) * scale + bias`` (head i of
    batch row j reads bias row j), then the causal mask."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if bias is not None:
        heads = q.shape[0] // bias.shape[0]
        s = s + bias.float().repeat_interleave(heads, dim=0)[:, None, :]
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device) \
            .tril(sk - sq)
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_ref(q, k, v, bias=None, causal=False, scale=None):
    """(o [bh, s_q, d] in q's dtype, lse [bh, s_q] f32) of attention over
    q [bh, s_q, d], k and v [bh, s_k, d] with the optional f32 key bias
    [b, s_k]. P is rounded to v's dtype before P . V and the max starts at
    NEG_INF, as in the kernels; l and every product are f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    s = _scores_ref(q, k, bias, causal, scale)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return o.to(q.dtype), (m + torch.log(denom))[..., 0]


def flash_delta(o, do):
    """``rowsum(dO * O)`` in f32 [bh, s_q] over the saved, rounded O."""
    return (do.float() * o.float()).sum(dim=-1)


def _bwd_ref(q, k, v, bias, do, lse, delta, causal, scale, need_dq=True,
             need_dkv=True):
    s = _scores_ref(q, k, bias, causal, scale)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = dk = dv = None
    if need_dq:
        dq = torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)
    if need_dkv:
        dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                          q.float()).to(k.dtype)
        dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2),
                          do.float()).to(v.dtype)
    return dq, dk, dv


def flash_bwd_ref(q, k, v, bias, o, lse, do, causal=False, scale=None):
    """(dq, dk, dv), each in its input's dtype, from the saved o and lse
    and the upstream dO. ds is rounded to k's dtype for dq and to q's for
    dk, P to dO's for dv, as the kernels do; products are f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _bwd_ref(q, k, v, bias, do, lse, flash_delta(o, do), causal,
                    scale)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(name, q, k, v, bias, dense=(), rows=()):
    """Shapes and types every kernel takes: ``dense`` are more [bh, s_q,
    d] inputs (dO), ``rows`` [bh, s_q] f32 ones (lse, delta). Returns
    (bh, s_q, s_k, d, heads)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{name}: need q [bh, s_q, d], k and v [bh, s_k, "
                         f"d]; got q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError(f"{name}: k{tuple(k.shape)} / v{tuple(v.shape)} "
                         f"do not match q{tuple(q.shape)}")
    if sq < 1 or sk < 1 or d < 1:
        raise ValueError(f"{name}: empty input q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    heads = 1
    if bias is not None:
        if bias.dim() != 2 or bias.shape[1] != sk or bias.shape[0] < 1 \
                or bh % bias.shape[0]:
            raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                             f"[b, {sk}] with b dividing {bh}")
        heads = bh // bias.shape[0]
    for t in dense:
        if t.shape != q.shape:
            raise ValueError(f"{name}: dO {tuple(t.shape)} != q "
                             f"{tuple(q.shape)}")
    for t in rows:
        if t.shape != (bh, sq):
            raise ValueError(f"{name}: per-row input {tuple(t.shape)} != "
                             f"({bh}, {sq})")
    tensors = [q, k, v, *dense, *rows] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    if q.device.type == "cpu":
        return bh, sq, sk, d, heads
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _SUPPORTED:
        raise TypeError(f"{name}: dtype {q.dtype} not in {_SUPPORTED}")
    for t in (k, v, *dense):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q is {q.dtype} but an input is "
                            f"{t.dtype}")
    for t in (q, k, v, *dense):
        if not t.is_contiguous():
            raise ValueError(f"{name}: q, k, v and dO must be contiguous")
    for t in (*rows, *([bias] if bias is not None else [])):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: bias, lse and delta must be "
                             f"contiguous f32")
    if d > _MAX_D:
        raise ValueError(f"{name}: head dim {d} > {_MAX_D}")
    return bh, sq, sk, d, heads


def _ptr(t):
    return None if t is None else t.data_ptr()


def _entry(kernel, dtype, d, aligned):
    """The csrc entry point that a CUDA call of ``kernel`` ("fwd",
    "bwd_dq" or "bwd_dkv") launches: the Hopper kernel where
    ``_sm90_path`` says so, else flash_attention.cu's."""
    if _sm90_path(dtype, d, aligned):
        return f"flash_sm90_{kernel}"
    return f"flash_attention_{kernel}"


def _launch(wrapper, kernel, ptrs, q, dims, scale, causal, dense):
    """Launch ``kernel`` for ``wrapper`` on q's device and current stream
    with ``ptrs``, then ``dims`` (BH, H, Sq, Sk, D), the scale and the
    flags; raise on a launch error, else count the launch (and the Hopper
    one, and the f16 one). ``dense`` are the [s, d] inputs: the Hopper
    kernels and flash_attention.cu's vector loads need them 16-byte
    aligned (and the latter d % 8 == 0); a Hopper entry point takes no
    vector flag, only the dtype code."""
    aligned = _aligned(dense)
    entry = _entry(kernel, q.dtype, dims[-1], aligned)
    sm90 = entry.startswith("flash_sm90")
    code = _dtype_code(q.dtype)
    flags = (code,) if sm90 else (int(dims[-1] % 8 == 0 and aligned), code)
    with torch.cuda.device(q.device):
        status = _fn(entry)(
            *ptrs, *dims, float(scale), int(bool(causal)), *flags,
            torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{wrapper.__name__}: CUDA launch failed with "
                           f"cudaError_t {status}")
    wrapper.launches += 1
    wrapper.launches_sm90 += sm90
    wrapper.launches_f16 += q.dtype == torch.float16


def flash_fwd(q, k, v, bias=None, causal=False, scale=None):
    """(o [bh, s_q, d] in q's dtype, lse [bh, s_q] f32). CUDA tensors
    launch the kernel; CPU tensors run ``flash_fwd_ref``."""
    bh, sq, sk, d, heads = _check("flash_fwd", q, k, v, bias)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, bias, causal, scale)
    out = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    _launch(flash_fwd, "fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
             out.data_ptr(), lse.data_ptr()),
            q, (bh, heads, sq, sk, d), scale, causal, (q, k, v))
    return out, lse


def flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=False, scale=None):
    """dq [bh, s_q, d] in q's dtype from the saved lse and ``delta``
    (``flash_delta(o, do)``). CUDA tensors launch the kernel; CPU tensors
    run the plain backward."""
    bh, sq, sk, d, heads = _check("flash_bwd_dq", q, k, v, bias, (do,),
                                  (lse, delta))
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, bias, do, lse, delta, causal, scale,
                        need_dkv=False)[0]
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq, "bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, (bh, heads, sq, sk, d), scale, causal, (q, k, v, do))
    return dq


def flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal=False, scale=None):
    """(dk, dv) [bh, s_k, d] in k's and v's dtype from the saved lse and
    ``delta``. CUDA tensors launch the kernel; CPU tensors run the plain
    backward."""
    bh, sq, sk, d, heads = _check("flash_bwd_dkv", q, k, v, bias, (do,),
                                  (lse, delta))
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return _bwd_ref(q, k, v, bias, do, lse, delta, causal, scale,
                        need_dq=False)[1:]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(flash_bwd_dkv, "bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr()),
            q, (bh, heads, sq, sk, d), scale, causal, (q, k, v, do))
    return dk, dv


for _w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _w.launches = _w.launches_sm90 = _w.launches_f16 = 0


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with the kernels' backward: saves (q, k, v, bias, o, lse)
    and recomputes the scores tile by tile in dq and dk/dv. lse is a
    statistic: no gradient flows through it. The bias is data: its
    gradient is zeros, as in the TPU kernels' custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        o, lse = flash_fwd(q, k, v, bias, causal, scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        need_q, need_k, need_v, need_b = ctx.needs_input_grad[:4]
        dq = dk = dv = None
        if need_q:
            dq = flash_bwd_dq(q, k, v, bias, do, lse, delta, ctx.causal,
                              ctx.scale)
        if need_k or need_v:
            dk, dv = flash_bwd_dkv(q, k, v, bias, do, lse, delta,
                                   ctx.causal, ctx.scale)
        dbias = torch.zeros_like(bias) if need_b else None
        return dq, dk if need_k else None, dv if need_v else None, dbias, \
            None, None


def flash_attention(q, k, v, bias=None, causal=False, scale=None,
                    return_lse=False):
    """Online-softmax attention, O(s) memory (paddle_tpu's
    ``flash_attention``, flash_attention.py:509-589).

    q: [b, h, s_q, d]; k, v: [b, h, s_k, d]; bias: optional additive key
    mask [b, s_k] (use NEG_INF-scale values for masked keys; treated as
    data). Returns [b, h, s_q, d] in q's dtype; with return_lse=True also
    the per-row logsumexp [b, h, s_q] (f32), through which no gradient
    flows. q, k and v are copied to contiguous [b*h, s, d] here (callers
    pass head-split views of one projection); the copies cost
    3 * b * s * h * d elements against the kernels' O(s^2 d) work."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape[3] != d or v.shape[3] != d or v.shape[2] != sk:
        raise ValueError(
            f"flash_attention needs matching head_dim/seq for k and v; got "
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    scale = d ** -0.5 if scale is None else float(scale)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    qf = q.reshape(b * h, sq, d).contiguous()
    kf = k.reshape(b * h, sk, d).contiguous()
    vf = v.reshape(b * h, sk, d).contiguous()
    if torch.compiler.is_exporting():
        if return_lse:
            raise NotImplementedError("flash_attention under torch.export "
                                      "returns the output only")
        out = flash_attention_fwd_op(qf, kf, vf, bias, bool(causal), scale)
        return out.reshape(b, h, sq, d)
    out, lse = _FlashAttention.apply(qf, kf, vf, bias, bool(causal), scale)
    out = out.reshape(b, h, sq, d)
    if return_lse:
        return out, lse.reshape(b, h, sq)
    return out


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor], causal: bool,
                           scale: float) -> torch.Tensor:
    """``flash_fwd``'s output on [b*h, s, d], as a torch custom op."""
    return flash_fwd(q, k, v, bias, causal, scale)[0]


@flash_attention_fwd_op.register_kernel("cpu")
def _flash_attention_fwd_op_cpu(q, k, v, bias, causal, scale):
    return flash_fwd_ref(q, k, v, bias, causal, scale)[0]


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_op_fake(q, k, v, bias, causal, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)
