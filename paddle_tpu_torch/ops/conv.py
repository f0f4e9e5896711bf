"""Convolution, pooling and resampling ops (paddle_tpu/ops/conv.py).

No JAX op here reaches a Pallas kernel: convs are
``lax.conv_general_dilated`` and pools ``lax.reduce_window``, so the
port's counterparts are torch's library calls (cuDNN on the card), with
the JAX ops' contracts kept where torch's differ:

- **Padding.** An int, one int per spatial dim, or 2·nd ints read as
  ``(lo, hi)`` pairs per dim, or ``'SAME'`` / ``'VALID'``. SAME pads are
  XLA's (``lax.padtype_to_pads``): output ``ceil(L / s)``, the total pad
  over the dilated kernel, the odd element on the high side. Symmetric
  pads go to torch's ``padding``; the rest are an explicit ``F.pad``.
- **bf16 convs** round the product to bf16 and then add the bias (two
  roundings, as JAX does): the bias is never fused into the call.
- **Layouts.** ``conv1d`` / ``conv2d`` under NLC / NHWC read HIO / HWIO
  weights (XLA's dimension numbers), ``conv3d`` and the transposes are
  channels-first whatever ``data_format`` says, and ``interpolate`` /
  ``pixel_shuffle`` treat their input as NCHW; all as in JAX.
- **ceil_mode** widens only the high pad, so a last window may hold
  padding alone: max gives -inf there and an exclusive average 0 / 0 =
  nan, as in JAX (torch's own ceil rule drops such a window). The pools
  pad explicitly (-inf or 0) and run with no padding of their own
  wherever the pads are not torch's symmetric ones.
- **Average divisors.** Non-exclusive divides by ``prod(k)``; string
  padding is never exclusive; exclusive counts the real elements of each
  window (neither pad nor ceil overhang).
- **Adaptive pools.** Divisible sizes average or max equal blocks; the
  non-divisible average is an integral image in the input dtype; the
  non-divisible max raises, as in JAX.
- **interpolate is ``jax.image.resize``**: ``align_corners`` is ignored,
  ``area`` means linear, cubic is Keys' kernel with a = -0.5, a
  downsampling axis is antialiased (the kernel widened by the inverse
  scale) and nearest samples at half-pixel centres. Linear and cubic are
  one weight matrix per resized axis (float64, cast to the input dtype)
  applied as a matrix product; nearest is an index gather.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from ._dispatch import defop, wrap

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool2d", "avg_pool3d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool3d",
           "max_pool2d_with_index", "max_unpool2d", "interpolate",
           "pixel_shuffle", "unfold", "affine_channel", "row_conv",
           "im2sequence", "psroi_pool", "deform_conv2d", "deformable_conv",
           "random_crop", "shuffle_batch"]

_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}
_MAX_POOL = {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG_POOL = {2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, nd):
    """A Paddle padding spec -> 'SAME' / 'VALID' or [(lo, hi)] per dim."""
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"bad padding {padding!r}")
        return p
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(spatial, window, strides):
    """XLA's SAME pads (lax.padtype_to_pads): the output ceil(L / s), the
    odd element of the total on the high side."""
    pads = []
    for size, k, s in zip(spatial, window, strides):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _resolve(pad, spatial, window, strides):
    if pad == "SAME":
        return _same_pads(spatial, window, strides)
    if pad == "VALID":
        return [(0, 0)] * len(spatial)
    return pad


def _flat_pads(pads):
    """[(lo, hi)] per spatial dim -> F.pad's list (the last dim first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _symmetric(pads):
    return all(lo == hi and lo >= 0 for lo, hi in pads)


def _bias_shape(nd, channels_last):
    return (1,) + (1,) * nd + (-1,) if channels_last \
        else (1, -1) + (1,) * nd


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             channels_last):
    stride = _pair(stride, nd)
    dilation = _pair(dilation, nd)
    if channels_last:
        # N...C input, ...IO weight (XLA's NHWC / HWIO dimension numbers)
        x = torch.movedim(x, -1, 1)
        weight = weight.permute(nd + 1, nd, *range(nd))
    k = weight.shape[2:]
    dilated = [(kk - 1) * d + 1 for kk, d in zip(k, dilation)]
    pads = _resolve(_conv_padding(padding, nd), x.shape[2:], dilated, stride)
    if _symmetric(pads):
        out = _CONV[nd](x, weight, None, stride, [lo for lo, _ in pads],
                        dilation, groups)
    else:
        out = _CONV[nd](tF.pad(x, _flat_pads(pads)), weight, None, stride,
                        0, dilation, groups)
    if channels_last:
        out = torch.movedim(out, 1, -1)
    if bias is not None:
        # after the conv: a bf16 product is rounded before the bias add
        out = torch.add(out, torch.reshape(bias, _bias_shape(nd,
                                                             channels_last)))
    return out


@defop
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format != "NCHW")


@defop
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format != "NCL")


@defop
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    False)


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, nd):
    """The gradient of a conv with ``weight`` (IO<spatial>, per group)
    w.r.t. its input: the full transposed output cut by ``lo`` at the low
    side and ``hi - output_padding`` at the high side (zeros past its end),
    which is JAX's input-dilated conv; torch's own padding takes the
    symmetric cases its ``output_padding`` rule allows."""
    stride = _pair(stride, nd)
    dilation = _pair(dilation, nd)
    opad = _pair(output_padding, nd)
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    pads = _conv_padding(padding, nd)
    if _symmetric(pads) and all(o < max(s, d) for o, s, d in
                                zip(opad, stride, dilation)):
        out = _CONV_T[nd](x, weight, None, stride, [lo for lo, _ in pads],
                          opad, groups, dilation)
    else:
        full = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
        out = tF.pad(full, _flat_pads([(-lo, o - hi) for (lo, hi), o in
                                       zip(pads, opad)]))
    if bias is not None:
        out = torch.add(out, torch.reshape(bias, (1, -1) + (1,) * nd))
    return out


@defop
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, nd=1)


@defop
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, nd=2)


@defop
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, nd=3)


# -- pooling -----------------------------------------------------------------

def _ceil_adjust(pads, spatial, window, strides):
    """The high pads widened so that floor division counts paddle's
    ceil_mode windows (JAX's rule: the last window may be padding only)."""
    out = []
    for (lo, hi), size, k, s in zip(pads, spatial, window, strides):
        eff = size + lo + hi
        extra = (-((eff - k) // -s)) * s + k - eff
        out.append((lo, hi + max(extra, 0)))
    return out


def _pool_pads(padding, spatial, k, s, ceil_mode):
    """([(lo, hi)] per spatial dim, whether the padding was a string)."""
    pad = _conv_padding(padding, len(k))
    if isinstance(pad, str):
        if ceil_mode:
            raise NotImplementedError("ceil_mode with string padding")
        return _resolve(pad, spatial, k, s), True
    if ceil_mode:
        pad = _ceil_adjust(pad, spatial, k, s)
    return pad, False


def _torch_pads(pads, k):
    """The pads as torch pooling's own ``padding``, or None where torch
    cannot take them (asymmetric, or more than half the window)."""
    if _symmetric(pads) and all(lo <= kk // 2 for (lo, _), kk in
                                zip(pads, k)):
        return [lo for lo, _ in pads]
    return None


def _windows(x, k, s):
    """[N, C, *out, *k] windows of a channels-first x (a view)."""
    for d, (kk, ss) in enumerate(zip(k, s)):
        x = x.unfold(2 + d, kk, ss)
    return x


def _max_pool(x, k, s, pads):
    """Channels-first max over windows; -inf (an integer's minimum) in the
    padding. The gradient goes to the first maximum of a window in
    row-major order, as XLA's select-and-scatter gives it."""
    nd = len(k)
    if x.is_floating_point():
        own = _torch_pads(pads, k)
        if own is not None:
            return _MAX_POOL[nd](x, k, s, own)
        return _MAX_POOL[nd](tF.pad(x, _flat_pads(pads), value=-math.inf),
                             k, s)
    fill = torch.iinfo(x.dtype).min
    xp = tF.pad(x, _flat_pads(pads), value=fill) if any(
        lo or hi for lo, hi in pads) else x
    return torch.amax(_windows(xp, k, s),
                      dim=tuple(range(-nd, 0)))


def _avg_pool(x, k, s, pads, exclusive):
    """Channels-first window sums over the count of real elements
    (``exclusive``) or over prod(k)."""
    nd = len(k)
    own = _torch_pads(pads, k)
    if own is not None:
        return _AVG_POOL[nd](x, k, s, own, count_include_pad=not exclusive)
    xp = tF.pad(x, _flat_pads(pads))
    total = _AVG_POOL[nd](xp, k, s, divisor_override=1)
    if not exclusive:
        return torch.div(total, float(np.prod(k)))
    ones = tF.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                             device=x.device), _flat_pads(pads))
    counts = _AVG_POOL[nd](ones, k, s, divisor_override=1)
    return torch.div(total, counts)


def _pool(x, kernel_size, stride, padding, ceil_mode, nd, channels_last,
          kind, exclusive=True):
    k = _pair(kernel_size, nd)
    s = _pair(stride, nd) if stride is not None else k
    if channels_last:
        x = torch.movedim(x, -1, 1)
    pads, stringy = _pool_pads(padding, x.shape[2:], k, s, ceil_mode)
    if kind == "max":
        out = _max_pool(x, k, s, pads)
    else:
        out = _avg_pool(x, k, s, pads, exclusive and not stringy)
    return torch.movedim(out, 1, -1) if channels_last else out


@defop
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, ceil_mode, 2,
                 data_format != "NCHW", "max")


@defop
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCHW"):
    return _pool(x, kernel_size, stride, padding, ceil_mode, 2,
                 data_format != "NCHW", "avg", exclusive)


@defop
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    return _pool(x, kernel_size, stride, padding, ceil_mode, 1, False, "max")


@defop
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, ceil_mode, 3, False, "max")


@defop
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCDHW"):
    return _pool(x, kernel_size, stride, padding, ceil_mode, 3, False,
                 "avg", exclusive)


@defop
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    oh, ow = _pair(output_size)
    if data_format != "NCHW":
        raise NotImplementedError
    n, c, h, w = x.shape
    if h % oh == 0 and w % ow == 0:
        return torch.mean(torch.reshape(x, (n, c, oh, h // oh, ow, w // ow)),
                          dim=(3, 5))
    # the integral image, in the input dtype as JAX computes it
    cs = torch.cumsum(torch.cumsum(x, dim=2), dim=3)
    cs = tF.pad(cs, (1, 0, 1, 0))
    hs = np.floor(np.arange(oh) * h / oh).astype(int)
    he = np.ceil((np.arange(oh) + 1) * h / oh).astype(int)
    ws = np.floor(np.arange(ow) * w / ow).astype(int)
    we = np.ceil((np.arange(ow) + 1) * w / ow).astype(int)
    area = (he - hs)[:, None] * (we - ws)[None, :]

    def at(rows, cols):
        r = torch.as_tensor(rows, device=x.device)
        q = torch.as_tensor(cols, device=x.device)
        return torch.index_select(torch.index_select(cs, 2, r), 3, q)

    out = at(he, we) - at(hs, we) - at(he, ws) + at(hs, ws)
    return torch.div(out, torch.as_tensor(area, dtype=x.dtype,
                                          device=x.device))


@defop
def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    oh, ow = _pair(output_size)
    n, c, h, w = x.shape
    if h % oh or w % ow:
        raise NotImplementedError("adaptive_max_pool2d needs divisible sizes")
    return torch.amax(torch.reshape(x, (n, c, oh, h // oh, ow, w // ow)),
                      dim=(3, 5))


def _blocks3d(x, output_size, name):
    od, oh, ow = _pair(output_size, 3)
    n, c, d, h, w = x.shape
    if d % od or h % oh or w % ow:
        raise ValueError(f"{name} needs divisible sizes")
    return torch.reshape(x, (n, c, od, d // od, oh, h // oh, ow, w // ow))


@defop
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return torch.mean(_blocks3d(x, output_size, "adaptive_avg_pool3d"),
                      dim=(3, 5, 7))


@defop
def adaptive_max_pool3d(x, output_size, data_format="NCDHW"):
    return torch.amax(_blocks3d(x, output_size, "adaptive_max_pool3d"),
                      dim=(3, 5, 7))


@defop
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          ceil_mode=False):
    """Max pool returning (out, flat h*w argmax indices int32). As JAX's
    (``conv_general_dilated_patches``), the padding is zeros, a window's
    index is its first maximum, and ties share the gradient evenly;
    ``ceil_mode`` is accepted and not applied."""
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    pad = _conv_padding(padding, 2)
    if isinstance(pad, str):
        raise ValueError("max_pool2d_with_index needs explicit padding")
    n, c, h, w = x.shape
    xp = tF.pad(x, _flat_pads(pad))
    oh = (xp.shape[2] - k[0]) // s[0] + 1
    ow = (xp.shape[3] - k[1]) // s[1] + 1
    patches = torch.reshape(tF.unfold(xp, k, stride=s),
                            (n, c, k[0] * k[1], oh, ow))
    out = torch.amax(patches, dim=2)
    arg = torch.argmax(patches, dim=2).to(torch.int32)
    iy = torch.arange(oh, dtype=torch.int32, device=x.device)[:, None] \
        * s[0] - pad[0][0] + arg // k[1]
    ix = torch.arange(ow, dtype=torch.int32, device=x.device)[None, :] \
        * s[1] - pad[1][0] + arg % k[1]
    return out, iy * w + ix


@defop
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None):
    """Pooled values scattered back to their argmax positions in zeros."""
    k = _pair(kernel_size)
    s = _pair(stride) if stride is not None else k
    n, c, oh, ow = x.shape
    if output_size is None:
        h = (oh - 1) * s[0] + k[0] - 2 * _pair(padding)[0]
        w = (ow - 1) * s[1] + k[1] - 2 * _pair(padding)[1]
    else:
        h, w = int(output_size[-2]), int(output_size[-1])
    flat = torch.zeros((n, c, h * w), dtype=x.dtype, device=x.device)
    out = torch.scatter(flat, 2, torch.reshape(indices, (n, c, -1)).long(),
                        torch.reshape(x, (n, c, -1)))
    return torch.reshape(out, (n, c, h, w))


# -- resampling --------------------------------------------------------------

def _triangle(t):
    return np.maximum(0.0, 1.0 - np.abs(t))


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = np.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return np.where(t >= 2.0, 0.0, out)


def _resize_weights(m, n, method):
    """[m, n] float64 weights of one axis resized from m to n samples
    (jax.image's ``compute_weight_mat``, translation 0, antialiased)."""
    kernel = _triangle if method == "linear" else _keys_cubic
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    t = np.abs(sample[None, :] - np.arange(m, dtype=np.float64)[:, None]) \
        / kernel_scale
    weights = kernel(t)
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(
        np.finfo(np.float32).eps), weights / np.where(total != 0, total, 1),
        0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], weights, 0.0)


@defop
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    n, c, h, w = x.shape
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor,) * 2
        size = (int(h * sf[0]), int(w * sf[1]))
    size = tuple(int(s) for s in size)
    method = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    out = x if method == "nearest" or x.is_floating_point() \
        else x.to(torch.float32)
    for axis, (m, k) in ((2, (h, size[0])), (3, (w, size[1]))):
        if m == k:
            continue
        if method == "nearest":
            src = torch.floor((torch.arange(k, dtype=torch.float32,
                                            device=x.device) + 0.5) * m / k)
            out = torch.index_select(out, axis, src.long())
        else:
            wm = torch.as_tensor(_resize_weights(m, k, method),
                                 dtype=out.dtype, device=x.device)
            out = torch.movedim(torch.tensordot(out, wm, dims=([axis], [0])),
                                -1, axis)
    return out.to(x.dtype)


@defop
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    n, c, h, w = x.shape
    x = torch.reshape(x, (n, c // (r * r), r, r, h, w))
    x = torch.permute(x, (0, 1, 4, 2, 5, 3))
    return torch.reshape(x, (n, c // (r * r), h * r, w * r))


@defop
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return tF.unfold(x, _pair(kernel_sizes), dilation=_pair(dilations),
                     padding=_pair(paddings), stride=_pair(strides))


@defop
def affine_channel(x, scale, bias, data_format="NCHW"):
    shape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
    return torch.add(torch.mul(x, torch.reshape(scale, shape)),
                     torch.reshape(bias, shape))


@defop
def row_conv(x, weight):
    """x [b, t, d], weight [future_context + 1, d]; out[t] = sum_i x[t + i]
    * w[i] (zeros past the end)."""
    out = 0
    for i in range(weight.shape[0]):
        shifted = tF.pad(x[:, i:], (0, 0, 0, i))
        out = torch.add(out, torch.mul(shifted, weight[i]))
    return out


@defop
def im2sequence(x, kernel_size, stride=1, padding=0):
    """Sliding patches flattened to [n * oh * ow, c * kh * kw] rows."""
    k = _pair(kernel_size)
    c = x.shape[1]
    cols = unfold.raw(x, k, strides=_pair(stride), paddings=_pair(padding))
    return torch.reshape(torch.transpose(cols, 1, 2), (-1, c * k[0] * k[1]))


@defop
def psroi_pool(x, boxes, boxes_num=None, output_channels=None,
               spatial_scale=1.0, pooled_height=7, pooled_width=7):
    """Position-sensitive ROI average pooling of the first image: bin (i,
    j) of a box averages channel group i * pw + j over the cells
    [floor(y1 + i bh), ceil(y1 + (i + 1) bh)) x the same in x (at least one
    cell counted); [boxes, oc, ph, pw]."""
    ph, pw = int(pooled_height), int(pooled_width)
    _, c, h, w = x.shape
    oc = output_channels or c // (ph * pw)
    img = torch.reshape(x[0][:ph * pw * oc], (ph * pw, oc, h, w))
    x1, y1, x2, y2 = (boxes[:, i] * spatial_scale for i in range(4))
    bh = torch.clamp_min(y2 - y1, 0.1) / ph
    bw = torch.clamp_min(x2 - x1, 0.1) / pw
    dev = x.device
    ii = torch.arange(ph, dtype=bh.dtype, device=dev)
    jj = torch.arange(pw, dtype=bw.dtype, device=dev)
    ys = torch.floor(y1[:, None] + ii * bh[:, None]).to(torch.int32)
    ye = torch.ceil(y1[:, None] + (ii + 1) * bh[:, None]).to(torch.int32)
    xs = torch.floor(x1[:, None] + jj * bw[:, None]).to(torch.int32)
    xe = torch.ceil(x1[:, None] + (jj + 1) * bw[:, None]).to(torch.int32)
    yy = torch.arange(h, dtype=torch.int32, device=dev)
    xx = torch.arange(w, dtype=torch.int32, device=dev)
    rows = (yy >= ys[..., None]) & (yy < ye[..., None])     # [B, ph, h]
    cols = (xx >= xs[..., None]) & (xx < xe[..., None])     # [B, pw, w]
    m = rows[:, :, None, :, None] & cols[:, None, :, None, :]
    m = torch.reshape(m, (m.shape[0], ph * pw, h, w))
    cnt = torch.clamp_min(torch.sum(m, dim=(2, 3)), 1).to(x.dtype)
    sums = torch.einsum("gohw,bghw->bgo", img, m.to(x.dtype))
    out = sums / cnt[..., None]
    return torch.permute(torch.reshape(out, (-1, ph, pw, oc)), (0, 3, 1, 2))


def random_crop(x, shape, seed=0):
    """A crop of the trailing dims to ``shape`` at host-random offsets
    (``np.random.RandomState(seed)``, JAX's draws); no gradient."""
    xv = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    rng = np.random.RandomState(seed)
    lead = xv.ndim - len(shape)
    starts = [int(rng.randint(0, xv.shape[lead + i] - s + 1))
              for i, s in enumerate(shape)]
    idx = (slice(None),) * lead + tuple(slice(b, b + s) for b, s in
                                        zip(starts, shape))
    return wrap(xv.detach()[idx].clone())


def shuffle_batch(x, seed=0):
    """The batch rows in a host-random order
    (``np.random.RandomState(seed).permutation``); no gradient."""
    xv = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    perm = np.random.RandomState(seed).permutation(xv.shape[0])
    return wrap(xv.detach()[torch.as_tensor(perm, device=xv.device)])


@defop
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (v2 with ``mask``): each kernel tap reads
    the input bilinearly at its learned offset (zeros outside), times the
    tap's mask; then one f32 contraction per group.

    x [n, ci, h, w]; offset [n, 2 dg kh kw, oh, ow], (y, x) per tap; mask
    [n, dg kh kw, oh, ow] or None; weight [co, ci / groups, kh, kw]."""
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    n, ci, h, w = x.shape
    co, _, kh, kw = weight.shape
    oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    K = kh * kw
    dg = int(deformable_groups)
    cg = ci // dg
    off = torch.reshape(offset.to(torch.float32), (n, dg, K, 2, oh, ow))
    m = None if mask is None else torch.reshape(
        mask.to(torch.float32), (n, dg, K, oh, ow))
    dev = x.device
    oy = torch.arange(oh, dtype=torch.float32, device=dev)[:, None] * s[0] \
        - p[0]
    ox = torch.arange(ow, dtype=torch.float32, device=dev)[None, :] * s[1] \
        - p[1]
    xg = torch.reshape(x, (n, dg, cg, h * w))

    def tap(yy, xx):
        inb = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[:, :, None]
        cy = torch.clamp(yy, 0, h - 1).long()
        cx = torch.clamp(xx, 0, w - 1).long()
        idx = torch.reshape(cy * w + cx, (n, dg, 1, oh * ow))
        g = torch.gather(xg, 3, idx.expand(n, dg, cg, oh * ow))
        return torch.reshape(g, (n, dg, cg, oh, ow)) * inb.to(x.dtype)

    cols = []
    for t in range(K):
        py = oy[None, None] + (t // kw) * d[0] + off[:, :, t, 0]
        px = ox[None, None] + (t % kw) * d[1] + off[:, :, t, 1]
        y0, x0 = torch.floor(py), torch.floor(px)
        wy = (py - y0)[:, :, None].to(x.dtype)
        wx = (px - x0)[:, :, None].to(x.dtype)
        smp = (tap(y0, x0) * (1 - wy) * (1 - wx)
               + tap(y0, x0 + 1) * (1 - wy) * wx
               + tap(y0 + 1, x0) * wy * (1 - wx)
               + tap(y0 + 1, x0 + 1) * wy * wx)
        if m is not None:
            smp = smp * m[:, :, t][:, :, None].to(smp.dtype)
        cols.append(smp)
    col = torch.reshape(torch.stack(cols, dim=3),
                        (n, groups, ci // groups, K, oh, ow))
    wg = torch.reshape(weight, (groups, co // groups, ci // groups, K))
    out = torch.einsum("ngckhw,gock->ngohw", col.to(torch.float32),
                       wg.to(torch.float32)).to(x.dtype)
    out = torch.reshape(out, (n, co, oh, ow))
    if bias is not None:
        out = torch.add(out, torch.reshape(bias, (1, -1, 1, 1)))
    return out


def deformable_conv(x, offset, mask, weight, bias=None, stride=1,
                    padding=0, dilation=1, deformable_groups=1, groups=1,
                    im2col_step=None):
    """The v1 op name (mask None) and v2 (modulated)."""
    return deform_conv2d(x, offset, weight, bias, stride, padding,
                         dilation, deformable_groups, groups, mask)
