"""The long tail of math ops (paddle_tpu/ops/math_extra.py): 88 registry
names under the JAX names and versions.

Special functions are ``torch.special``'s (``polygamma``, ``gammainc`` /
``gammaincc``, the Bessel ``i0`` / ``i1`` and their scaled forms);
elementwise, indexing, distance, statistics and layout ops follow the
jnp formulas (``cdist`` / ``pdist`` as sums of squared differences,
``nanmedian`` as jnp's mean of the two middle values, ``cov`` as
``jnp.cov``). ``lu`` returns 1-based int32 pivots, as the JAX op does
(torch's LAPACK pivots already are). The random draws
(``standard_gamma``, ``binomial``, ``log_normal``) come from the port's
generator of the device, so only their distributions are JAX's;
``tdm_sampler`` keeps the JAX op's ``np.random.RandomState(seed)`` and so
its draws. The host ops (``edit_distance``, ``chunk_eval``, ``auc``'s
streaming sibling lives in ``metric``, ``filter_by_instag``,
``tdm_sampler``, ``py_func``) run on the host as in the JAX package: the
reference kernels are CPU loops too. ``py_func`` calls its numpy
function on the host copy of its inputs and returns tensors on their
device, with ``backward_func`` as the autograd backward.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import rng as _rng
from ..core.dtype import to_torch_dtype
from ..core.ragged import RaggedTensor
from ..device import resolve_device
from ._dispatch import defop, wrap

__all__ = [
    "polygamma", "gammaln", "igamma", "igammac", "trapezoid",
    "cumulative_trapezoid", "vander", "nextafter", "hypot", "copysign",
    "signbit", "sinc", "ldexp", "renorm", "frexp", "i0", "i0e", "i1",
    "i1e", "fix", "cummax", "cummin", "nanmedian", "nanquantile",
    "bucketize", "index_add", "index_fill", "index_put", "masked_scatter",
    "diagonal_scatter", "select_scatter", "slice_scatter", "unflatten",
    "view_as", "cdist", "pdist", "corrcoef", "cov", "cholesky_solve",
    "lu", "lu_unpack", "fold", "histogramdd", "standard_gamma", "binomial",
    "log_normal", "channel_shuffle", "pixel_unshuffle", "affine_grid",
    "grid_sample",
    "trace", "diag_embed", "multiplex", "cos_sim",
    "bilinear_tensor_product", "squared_l2_norm", "squared_l2_distance",
    "l1_norm", "clip_by_norm",
    "edit_distance", "mean_iou",
    "cvm", "hash_bucket", "batch_fc", "rank_attention",
    "match_matrix_tensor", "fsp_matrix", "conv_shift", "filter_by_instag",
    "fake_quantize_abs_max", "fake_quantize_moving_average_abs_max",
    "fake_channel_wise_quantize_abs_max", "dequantize_abs_max",
    "chunk_eval", "gru_unit", "lstm_unit",
    "fake_quantize_range_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_channel_wise_dequantize_max_abs", "fake_dequantize_max_abs",
    "tdm_child", "tdm_sampler",
    "accuracy", "auc", "py_func", "tree_conv",
]


def _host(x):
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(x)


def _scalar(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# -- special functions ------------------------------------------------------

@defop
def polygamma(x, n=1):
    return torch.special.polygamma(n, x)


@defop
def gammaln(x):
    return torch.special.gammaln(x)


@defop
def igamma(a, x):
    return torch.special.gammainc(a, x)


@defop
def igammac(a, x):
    return torch.special.gammaincc(a, x)


@defop
def i0(x):
    return torch.special.i0(x)


@defop
def i0e(x):
    return torch.special.i0e(x)


@defop
def i1(x):
    return torch.special.i1(x)


@defop
def i1e(x):
    return torch.special.i1e(x)


@defop
def sinc(x):
    return torch.sinc(x)


# -- elementwise ------------------------------------------------------------

@defop
def nextafter(x, y):
    return torch.nextafter(x, y)


@defop
def hypot(x, y):
    return torch.hypot(x, y)


@defop
def copysign(x, y):
    return torch.copysign(x, y)


@defop
def signbit(x):
    return torch.signbit(x)


@defop
def ldexp(x, y):
    # x * 2^y with a float power: torch.ldexp's backward takes 2^y in the
    # exponent's integer dtype, 0 for y < 0
    return x * torch.pow(2.0, y.to(x.dtype))


@defop
def fix(x):
    return torch.trunc(x)


@defop
def frexp(x):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


@defop
def vander(x, n=None, increasing=False):
    n = x.shape[-1] if n is None else n
    iota = torch.arange(n, device=x.device)
    if not increasing:
        iota = torch.flip(iota, (0,))
    return torch.pow(x[..., None], iota.to(x.dtype))


@defop
def renorm(x, p, axis, max_norm):
    axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, axes, keepdim=True) ** (1.0 / p)
    scale = torch.where(norms > max_norm,
                        max_norm / torch.clamp(norms, min=1e-12),
                        torch.ones_like(norms))
    return x * scale


# -- reductions / scans -----------------------------------------------------

@defop
def trapezoid(y, x=None, dx=1.0, axis=-1):
    if x is None:
        d = _scalar(dx, y)
    elif x.ndim == 1:
        d = torch.diff(x)
    else:
        d = torch.movedim(torch.diff(x, dim=axis), axis, -1)
    y = torch.movedim(y, axis, -1)
    return 0.5 * torch.sum(d * (y[..., 1:] + y[..., :-1]), -1)


@defop
def cumulative_trapezoid(y, x=None, dx=1.0, axis=-1):
    y = torch.movedim(y, axis, -1)
    if x is not None:
        if x.ndim > 1:
            x = torch.movedim(torch.broadcast_to(x, y.shape), axis, -1)
        d = torch.diff(x, dim=-1)
    else:
        d = dx
    avg = (y[..., 1:] + y[..., :-1]) * 0.5
    return torch.movedim(torch.cumsum(avg * d, -1), -1, axis)


def _cum_extreme(x, axis, op):
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals = op(x, axis).values
    shape = [-1 if i == axis % x.ndim else 1 for i in range(x.ndim)]
    iota = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    idx = torch.cummax(torch.where(x == vals, iota, torch.zeros_like(iota)),
                       axis).values
    return vals, idx.to(torch.int64)


@defop
def cummax(x, axis=None):
    return _cum_extreme(x, axis, torch.cummax)


@defop
def cummin(x, axis=None):
    return _cum_extreme(x, axis, torch.cummin)


def _nanq(x, q, axis, keepdim):
    if axis is None:
        x, axis = x.reshape(-1), 0
        if keepdim:
            raise ValueError("keepdim needs an axis")
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.nanquantile(x, qt, dim=axis, keepdim=keepdim)


@defop
def nanmedian(x, axis=None, keepdim=False):
    return _nanq(x, 0.5, axis, keepdim)


@defop
def nanquantile(x, q, axis=None, keepdim=False):
    return _nanq(x, q, axis, keepdim)


def _bin_edges(col, bins, rng):
    if rng is None:
        lo, hi = torch.amin(col), torch.amax(col)
    else:
        lo, hi = _scalar(rng[0], col), _scalar(rng[1], col)
    flat = hi == lo
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    step = torch.arange(bins + 1, dtype=col.dtype, device=col.device) / bins
    return torch.where(step == 1, hi, lo * (1 - step) + hi * step)


@defop
def histogramdd(x, bins=10, ranges=None, weights=None, density=False):
    n, d = x.shape
    per = list(bins) if isinstance(bins, (list, tuple)) else [bins] * d
    edges, flat = [], torch.zeros(n, dtype=torch.int64, device=x.device)
    for i in range(d):
        e = _bin_edges(x[:, i], int(per[i]), None if ranges is None
                       else ranges[i])
        idx = torch.searchsorted(e, x[:, i].contiguous(), right=True)
        idx = torch.where(x[:, i] == e[-1], idx - 1, idx)
        flat = flat * (len(e) + 1) + torch.clamp(idx, 0, len(e))
        edges.append(e)
    nb = tuple(len(e) + 1 for e in edges)
    w = torch.ones(n, dtype=torch.int64, device=x.device) if weights is None \
        else weights
    hist = torch.zeros(int(np.prod(nb)), dtype=w.dtype,
                       device=x.device).index_add(0, flat, w).reshape(nb)
    hist = hist[(slice(1, -1),) * d]
    if density:
        hist = hist.to(x.dtype)
        hist = hist / hist.sum()
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return hist, edges


# -- indexing ---------------------------------------------------------------

@defop
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, x, right=right,
                              out_int32=out_int32)


def _index_shape(x, axis, n):
    shape = list(x.shape)
    shape[axis] = n
    return shape


@defop
def index_add(x, index, axis, value):
    value = torch.broadcast_to(value, _index_shape(x, axis, index.shape[0]))
    return torch.index_add(x, axis, index.long(), value.to(x.dtype))


@defop
def index_fill(x, index, axis, value):
    if isinstance(value, torch.Tensor) and value.ndim:
        value = torch.broadcast_to(value, _index_shape(x, axis,
                                                       index.shape[0]))
        return torch.index_copy(x, axis, index.long(), value.to(x.dtype))
    return torch.index_fill(x, axis, index.long(), value)


@defop
def index_put(x, indices, value, accumulate=False):
    idx = tuple(torch.as_tensor(i, device=x.device).long()
                for i in indices)
    return torch.index_put(x, idx, torch.as_tensor(value, dtype=x.dtype,
                                                   device=x.device),
                           accumulate=accumulate)


@defop
def masked_scatter(x, mask, value):
    flat_val = value.reshape(-1)
    m = torch.broadcast_to(mask, x.shape).reshape(-1)
    pos = torch.cumsum(m.to(torch.int64), 0) - 1
    take = flat_val[torch.clamp(pos, 0, flat_val.shape[0] - 1)]
    return torch.where(m, take, x.reshape(-1)).reshape(x.shape)


@defop
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    return torch.diagonal_scatter(x, y, offset, axis1, axis2)


@defop
def select_scatter(x, y, axis, index):
    return torch.select_scatter(x, y, axis, index)


@defop
def slice_scatter(x, y, axes, starts, ends, strides=None):
    strides = strides or [1] * len(axes)
    idx = [slice(None)] * x.ndim
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[a] = slice(s, e, st)
    out = torch.clone(x)
    out[tuple(idx)] = y
    return out


@defop
def unflatten(x, axis, shape):
    axis = axis % x.ndim
    return torch.reshape(x, list(x.shape[:axis]) + list(shape)
                         + list(x.shape[axis + 1:]))


def view_as(x, other):
    from . import reshape
    return reshape(x, list(other.shape))


# -- distances / statistics -------------------------------------------------

def _pair_dist(d, p):
    if p == 2.0:
        return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=0.0))
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


@defop
def cdist(x, y, p=2.0):
    return _pair_dist(x[..., :, None, :] - y[..., None, :, :], p)


@defop
def pdist(x, p=2.0):
    n = x.shape[0]
    full = _pair_dist(x[:, None, :] - x[None, :, :], p)
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return full[iu[0], iu[1]]


@defop
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    X = x if x.ndim == 2 else x.reshape(1, -1)
    if not rowvar and x.ndim != 1:
        X = X.T
    ddof = 1 if ddof else 0
    w = None
    if fweights is not None:
        w = torch.abs(fweights).to(X.dtype)
    if aweights is not None:
        aw = torch.abs(aweights).to(X.dtype)
        w = aw if w is None else w * aw
    if w is None:
        avg = torch.mean(X, 1)
        f = X.shape[1] - ddof
    else:
        w_sum = torch.sum(w)
        avg = torch.sum(X * w, 1) / w_sum
        if ddof == 0:
            f = w_sum
        elif aweights is None:
            f = w_sum - ddof
        else:
            f = w_sum - ddof * torch.sum(w * aw) / w_sum
    X = X - avg[:, None]
    X_T = X.T if w is None else (X * w).T
    return torch.squeeze((X @ X_T) / f)


@defop
def corrcoef(x, rowvar=True):
    c = cov.raw(x, rowvar)
    if c.ndim == 0:
        return c / c
    d = torch.diagonal(c)
    std = torch.sqrt(d)
    c = c / std[:, None] / std[None, :]
    return torch.clamp(c, -1, 1)


# -- linalg -----------------------------------------------------------------

@defop
def cholesky_solve(x, y, upper=False):
    # the factor's other triangle is not read, so it has no gradient (as
    # jax.scipy's cho_solve)
    y = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(x, y, upper=upper)


@defop
def lu(x, pivot=True):
    lu_mat, piv = torch.linalg.lu_factor(x)
    return lu_mat, piv.to(torch.int32)   # 1-based, as the reference's


@defop
def lu_unpack(lu_mat, pivots, unpack_ludata=True, unpack_pivots=True):
    n = lu_mat.shape[-2]
    low = torch.tril(lu_mat, -1) + torch.eye(n, lu_mat.shape[-1],
                                             dtype=lu_mat.dtype,
                                             device=lu_mat.device)
    up = torch.triu(lu_mat)
    perm = list(range(n))
    for i, j in enumerate(_host(pivots).astype(np.int64).reshape(-1) - 1):
        perm[i], perm[j] = perm[j], perm[i]
    eye = torch.eye(n, dtype=lu_mat.dtype, device=lu_mat.device)
    pmat = eye[torch.as_tensor(perm, device=lu_mat.device)].T
    return pmat, low, up


# -- im2col inverse ---------------------------------------------------------

@defop
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im: x [N, C*kh*kw, L] -> [N, C, H, W]."""
    return tF.fold(x, output_sizes, kernel_sizes, dilation=dilations,
                   padding=paddings, stride=strides)


# -- random -----------------------------------------------------------------

@defop
def standard_gamma(alpha):
    return torch._standard_gamma(alpha, generator=_rng.generator(
        alpha.device))


@defop
def binomial(count, prob):
    count = torch.as_tensor(count, dtype=torch.float32, device=prob.device)
    count, prob = torch.broadcast_tensors(count, prob.float())
    return torch.binomial(count, prob,
                          generator=_rng.generator(prob.device))


@defop
def log_normal(mean=1.0, std=2.0, shape=None):
    dev = resolve_device()
    z = torch.randn(tuple(shape or ()), generator=_rng.generator(dev),
                    device=dev)
    return torch.exp(mean + std * z)


@defop
def channel_shuffle(x, groups, data_format="NCHW"):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w) \
            .permute(0, 2, 1, 3, 4).reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups) \
        .permute(0, 1, 2, 4, 3).reshape(n, h, w, c)


@defop
def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = downscale_factor
    n, c, h, w = x.shape
    return x.reshape(n, c, h // r, r, w // r, r) \
        .permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)


@defop
def affine_grid(theta, out_shape, align_corners=True):
    """reference affine_grid_op.cc: the (x, y) sampling grid [N, H, W, 2]
    of theta [N, 2, 3] for an output [N, C, H, W]."""
    _, _, H, W = [int(s) for s in out_shape]
    dev = theta.device

    def lin(m):
        if align_corners:
            step = torch.arange(m, dtype=torch.float32, device=dev) \
                / max(m - 1, 1)
            return torch.where(step == 1, 1.0, -1.0 * (1 - step) + step) \
                if m > 1 else torch.full((1,), -1.0, device=dev)
        return (torch.arange(m, dtype=torch.float32, device=dev) * 2 + 1) \
            / m - 1.0

    yg, xg = torch.meshgrid(lin(H), lin(W), indexing="ij")
    base = torch.stack([xg, yg, torch.ones_like(xg)], -1)
    return torch.einsum("hwk,njk->nhwj", base, theta.float())


def _gather_nc(x, iy, ix):
    """x [N, C, H, W] at integer maps [N, Ho, Wo] -> [N, C, Ho, Wo]."""
    n = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[n, :, iy, ix].permute(0, 3, 1, 2)


@defop
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """reference grid_sampler_op.cc: x [N, C, H, W] at grid [N, Ho, Wo, 2]
    ((x, y) in [-1, 1]), the JAX op's taps and rounding."""
    _, _, H, W = x.shape

    def unnorm(g, size):
        if align_corners:
            return (g + 1) * (size - 1) / 2
        return ((g + 1) * size - 1) / 2

    gx = unnorm(grid[..., 0].float(), W)
    gy = unnorm(grid[..., 1].float(), H)
    if padding_mode == "border":
        gx = torch.clamp(gx, 0, W - 1)
        gy = torch.clamp(gy, 0, H - 1)
    if mode == "nearest":
        ix = torch.clamp(torch.round(gx), 0, W - 1).long()
        iy = torch.clamp(torch.round(gy), 0, H - 1).long()
        if padding_mode == "zeros":
            valid = (gx >= -0.5) & (gx <= W - 0.5) & (gy >= -0.5) \
                & (gy <= H - 0.5)
        else:
            valid = torch.ones_like(gx, dtype=torch.bool)
        return _gather_nc(x, iy, ix) * valid[:, None].to(x.dtype)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0

    def tap(ix, iy):
        cx = torch.clamp(ix, 0, W - 1).long()
        cy = torch.clamp(iy, 0, H - 1).long()
        v = _gather_nc(x, cy, cx)
        if padding_mode == "zeros":
            inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = v * inb[:, None].to(x.dtype)
        return v

    wxe, wye = wx[:, None].to(x.dtype), wy[:, None].to(x.dtype)
    return (tap(x0, y0) * (1 - wxe) * (1 - wye)
            + tap(x0 + 1, y0) * wxe * (1 - wye)
            + tap(x0, y0 + 1) * (1 - wxe) * wye
            + tap(x0 + 1, y0 + 1) * wxe * wye)


# -- addmm's family: trace, diag_embed, multiplex, cos_sim ... ---------------

@defop
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.sum(torch.diagonal(x, offset, axis1, axis2), -1)


@defop
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


@defop
def multiplex(inputs, index):
    stacked = torch.stack([torch.as_tensor(t) for t in inputs], 0)
    idx = torch.reshape(index, (-1,)).long()
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


@defop
def cos_sim(x, y, eps=1e-8):
    xn = torch.sqrt(torch.sum(x * x, -1))
    yn = torch.sqrt(torch.sum(y * y, -1))
    return torch.sum(x * y, -1) / torch.clamp(xn * yn, min=eps)


@defop
def bilinear_tensor_product(x, y, weight, bias=None):
    out = torch.einsum("bm,kmn,bn->bk", x, weight, y)
    return out if bias is None else out + bias


@defop
def squared_l2_norm(x):
    return torch.sum(torch.square(x))


@defop
def squared_l2_distance(x, y):
    d = x - y
    return torch.sum(torch.square(d), tuple(range(1, d.ndim)))


@defop
def l1_norm(x):
    return torch.sum(torch.abs(x))


@defop
def clip_by_norm(x, max_norm):
    norm = torch.sqrt(torch.clamp(torch.sum(torch.square(x)), min=1e-12))
    return x * torch.clamp(max_norm / norm, max=1.0).to(x.dtype)


# -- metric-ish ops -----------------------------------------------------------

def _rows(x):
    if isinstance(x, RaggedTensor):
        return [_host(r) for r in x.to_list()]
    if isinstance(x, torch.Tensor):
        return list(_host(x))
    return [np.asarray(r) for r in x]


def edit_distance(hyps, refs, normalized=True):
    """reference edit_distance_op.cc: the Levenshtein distance of each
    (hypothesis, reference) pair, a host loop as the reference kernel;
    (distances [n, 1] f32, n)."""
    from ..core.tensor import to_tensor
    out = []
    for h, r in zip(_rows(hyps), _rows(refs)):
        m, n = len(h), len(r)
        dp = np.arange(n + 1, dtype=np.float64)
        for i in range(1, m + 1):
            prev = dp.copy()
            dp[0] = i
            for j in range(1, n + 1):
                cost = 0 if h[i - 1] == r[j - 1] else 1
                dp[j] = min(prev[j] + 1, dp[j - 1] + 1, prev[j - 1] + cost)
        d = dp[n]
        out.append(d / max(n, 1) if normalized else d)
    return to_tensor(np.asarray(out, np.float32).reshape(-1, 1)), len(out)


@defop
def mean_iou(input, label, num_classes):  # noqa: A002
    """reference mean_iou_op.cc: (mean IoU over the classes in pred or
    label, wrong counts, correct counts)."""
    pred = input.reshape(-1).long()
    lab = label.reshape(-1).long()
    n = int(num_classes)
    z = torch.zeros(n, dtype=torch.int64, device=pred.device)
    correct = z.index_add(0, lab, (pred == lab).long())
    pred_cnt = z.index_add(0, pred, torch.ones_like(pred))
    lab_cnt = z.index_add(0, lab, torch.ones_like(lab))
    union = pred_cnt + lab_cnt - correct
    present = union > 0
    iou = torch.where(present, correct / torch.clamp(union, min=1),
                      torch.zeros((), dtype=torch.float64,
                                  device=pred.device))
    miou = torch.sum(iou) / torch.clamp(torch.sum(present), min=1)
    return miou.float(), (pred_cnt - correct).int(), correct.int()


# -- industrial / CTR ops ---------------------------------------------------

@defop
def cvm(x, cvm_in=None, use_cvm=True):
    """reference cvm_op.cc: x's first two columns are (show, click)."""
    if not use_cvm:
        return x[:, 2:]
    show = torch.log(x[:, 0:1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - show
    return torch.cat([show, click, x[:, 2:]], 1)


@defop(version=2)
def hash_bucket(x, num_hash=1, mod_by=100000007):
    """reference hash_op.cc: ids -> num_hash bucket ids (multiplicative
    hashing, int64 wraparound, masked non-negative before the modulo)."""
    ids = x.long()
    seeds = torch.as_tensor([(0x9E3779B1 * (i + 1)) | 1
                             for i in range(num_hash)], dtype=torch.int64,
                            device=ids.device)
    h = ids[..., None] * seeds
    h = h ^ (h >> 16)
    return torch.remainder(h & 0x7FFFFFFFFFFFFFFF, mod_by)


@defop
def batch_fc(x, w, bias=None):
    out = torch.einsum("sbi,sio->sbo", x, w)
    return out if bias is None else out + bias[:, None]


@defop
def rank_attention(x, rank_offset, rank_param, max_rank=3):
    blk = torch.clamp(rank_offset[:, 0].long() - 1, 0,
                      rank_param.shape[0] - 1)
    return torch.einsum("ni,nio->no", x, rank_param[blk])


@defop
def match_matrix_tensor(x, y, w):
    return torch.einsum("nad,dte,nbe->ntab", x, w, y)


@defop
def fsp_matrix(x, y):
    _, _, h, w = x.shape
    return torch.einsum("nahw,nbhw->nab", x, y) / (h * w)


@defop
def conv_shift(x, y):
    half = y.shape[1] // 2
    out = 0
    for j in range(y.shape[1]):
        out = out + torch.roll(x, -(j - half), 1) * y[:, j:j + 1]
    return out


def filter_by_instag(x, ins_tag, filter_tag):
    """reference filter_by_instag_op.cc: the rows of x whose tag set meets
    ``filter_tag`` (a host loop); (rows, kept row indices)."""
    tags = [_host(t) for t in ins_tag.to_list()] \
        if isinstance(ins_tag, RaggedTensor) \
        else [_host(t).reshape(-1) for t in ins_tag]
    fset = set(_host(filter_tag).reshape(-1).tolist())
    keep = [i for i, t in enumerate(tags) if fset & set(t.tolist())]
    idx = torch.as_tensor(np.asarray(keep, np.int64), device=x.device)
    return wrap(x[idx]), wrap(idx)


# -- fake quantization (reference fake_quantize_op.cc) ----------------------

def _qmax(bits):
    return float(2 ** (bits - 1) - 1)


def _qdq(x, scale, n):
    q = torch.round(x / torch.clamp(scale, min=1e-12) * n)
    return torch.clamp(q, -n, n) / n * scale


@defop
def fake_quantize_abs_max(x, bit_length=8):
    scale = torch.amax(torch.abs(x))
    return _qdq(x, scale, _qmax(bit_length)), scale


@defop
def fake_quantize_moving_average_abs_max(x, in_state, bit_length=8,
                                         moving_rate=0.9):
    state = moving_rate * in_state + (1 - moving_rate) * torch.amax(
        torch.abs(x))
    return _qdq(x, state, _qmax(bit_length)), state


@defop
def fake_channel_wise_quantize_abs_max(x, bit_length=8, quant_axis=0):
    axes = tuple(i for i in range(x.ndim) if i != quant_axis)
    scale = torch.amax(torch.abs(x), axes, keepdim=True)
    return _qdq(x, scale, _qmax(bit_length)), torch.squeeze(scale)


@defop
def dequantize_abs_max(x, scale, max_range):
    return x.float() * scale / max_range


@defop
def fake_quantize_range_abs_max(x, in_scale, bit_length=8, window_size=10000,
                                is_test=False):
    scale = in_scale if is_test else torch.maximum(
        in_scale, torch.amax(torch.abs(x)))
    return _qdq(x, scale, _qmax(bit_length)), scale


@defop
def fake_quantize_dequantize_abs_max(x, bit_length=8):
    return fake_quantize_abs_max.raw(x, bit_length)


@defop
def fake_quantize_dequantize_moving_average_abs_max(x, in_state,
                                                    bit_length=8,
                                                    moving_rate=0.9):
    return fake_quantize_moving_average_abs_max.raw(x, in_state,
                                                    bit_length, moving_rate)


@defop
def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8,
                                                  quant_axis=0):
    return fake_channel_wise_quantize_abs_max.raw(x, bit_length, quant_axis)


@defop
def fake_channel_wise_dequantize_max_abs(x, scales, max_range=None,
                                         quant_axis=0, bit_length=8):
    n = _qmax(bit_length) if max_range is None else float(max_range)
    shape = [1] * x.ndim
    shape[quant_axis] = -1
    return x.float() * scales.reshape(shape) / n


@defop
def fake_dequantize_max_abs(x, scale, max_range):
    return dequantize_abs_max.raw(x, scale, max_range)


# -- tree-based deep match ----------------------------------------------------

@defop
def tdm_child(x, tree_info, child_nums):
    """reference tdm_child_op.cc: each node's children and their leaf mask
    (tree_info rows: [item_id, layer, parent, child_0 ...])."""
    ids = x.long()
    children = tree_info.long()[:, 3:3 + child_nums]
    ch = children[ids.reshape(-1)].reshape(ids.shape + (child_nums,))
    grand = children[ch.reshape(-1)].reshape(ch.shape + (child_nums,))
    leaf = (ch != 0) & torch.all(grand == 0, -1)
    return ch.int(), leaf.int()


def tdm_sampler(x, travel_list, layer_list, neg_samples_num_list,
                layer_node_num_list, leaf_node_num, output_positive=True,
                seed=0):
    """reference tdm_sampler_op.cc (a host sampler): per tree layer the
    positive node of each sample's path and uniform negatives of the
    layer, from ``np.random.RandomState(seed)`` as the JAX op, so a seed
    gives the JAX op's draws; (out, label, mask) [batch, sum(neg + pos)]."""
    from ..core.tensor import to_tensor
    rng = np.random.RandomState(seed or None)
    ids = _host(x).astype(np.int64).reshape(-1)
    travel = np.asarray(_host(travel_list), np.int64)
    layers = [np.asarray(_host(v), np.int64) for v in layer_list]
    outs, labels, masks = [], [], []
    for item in ids:
        row_o, row_l, row_m = [], [], []
        for li, (nodes, n_neg) in enumerate(zip(layers,
                                                neg_samples_num_list)):
            pos = int(travel[item, li])
            if output_positive:
                row_o.append(pos)
                row_l.append(1)
                row_m.append(0 if pos == 0 else 1)
            cand = nodes[nodes != pos]
            n_take = min(n_neg, len(cand))
            take = rng.choice(cand, size=n_take, replace=False) \
                if n_take else np.zeros(0, np.int64)
            row_o += [int(t) for t in take] + [0] * (n_neg - n_take)
            row_l += [0] * n_neg
            row_m += [1] * n_take + [0] * (n_neg - n_take)
        outs.append(row_o)
        labels.append(row_l)
        masks.append(row_m)
    return tuple(to_tensor(np.asarray(v, np.int64))
                 for v in (outs, labels, masks))


def chunk_eval(inferences, labels, chunk_scheme="IOB", num_chunk_types=1,
               seq_lengths=None):
    """reference chunk_eval_op.cc (a host metric): chunk precision, recall,
    F1 and the counts (num_infer, num_label, num_correct) under IOB with
    tag = type * 2 (B) / type * 2 + 1 (I), anything else Outside."""
    def extract(seq):
        chunks = set()
        start = ctype = None
        for i, t in enumerate(list(seq) + [-1]):
            t = int(t)
            if t < 0 or t >= 2 * num_chunk_types:
                b = ty = None
            else:
                ty, b = t // 2, ("B" if t % 2 == 0 else "I")
            if start is not None and (b is None or b == "B" or ty != ctype):
                chunks.add((start, i - 1, ctype))
                start = ctype = None
            if b == "B" or (b == "I" and start is None):
                start, ctype = i, ty
        return chunks

    inferences, labels = _host(inferences), _host(labels)
    if inferences.ndim == 1:
        inferences, labels = inferences[None], labels[None]
    lens = None if seq_lengths is None else _host(seq_lengths).reshape(-1)
    n_inf = n_lab = n_cor = 0
    for row in range(inferences.shape[0]):
        L = int(lens[row]) if lens is not None else inferences.shape[1]
        ic, lc = extract(inferences[row][:L]), extract(labels[row][:L])
        n_inf += len(ic)
        n_lab += len(lc)
        n_cor += len(ic & lc)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1, n_inf, n_lab, n_cor


@defop
def gru_unit(x, hidden_prev, weight, bias=None):
    """reference gru_unit_op.cc: one GRU step from x [b, 3d] (projected
    input); weight [d, 3d] is update | reset | candidate."""
    d = hidden_prev.shape[1]
    gates = x[:, :2 * d] + hidden_prev @ weight[:, :2 * d]
    if bias is not None:
        gates = gates + bias[:2 * d]
    u = torch.sigmoid(gates[:, :d])
    r = torch.sigmoid(gates[:, d:2 * d])
    c = x[:, 2 * d:] + (r * hidden_prev) @ weight[:, 2 * d:]
    if bias is not None:
        c = c + bias[2 * d:]
    c = torch.tanh(c)
    return u * hidden_prev + (1 - u) * c, r, c


@defop
def lstm_unit(x, cell_prev, forget_bias=0.0):
    """reference lstm_unit_op.cc: one LSTM step from gates x [b, 4d]
    (i | f | c | o) -> (hidden, cell)."""
    d = cell_prev.shape[1]
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + forget_bias)
    g = torch.tanh(x[:, 2 * d:3 * d])
    o = torch.sigmoid(x[:, 3 * d:])
    c = f * cell_prev + i * g
    return o * torch.tanh(c), c


@defop
def accuracy(input, label, k=1):  # noqa: A002
    """reference accuracy_op.cc: top-k accuracy of logits against labels."""
    top = torch.topk(input, k, -1).indices
    hit = torch.any(top == label.reshape(-1, 1).to(top.dtype), 1)
    return torch.mean(hit.float())


@defop
def auc(predict, label, num_thresholds=200):
    """reference auc_op.cc: ROC-AUC of one batch from thresholded TP / FP
    counts, integrated over the (fpr, tpr) staircase sorted as jnp's
    ``lexsort((tpr, fpr))``."""
    pos = predict[:, -1] if predict.ndim == 2 else predict.reshape(-1)
    lab = label.reshape(-1).float()
    thr = torch.linspace(0.0, 1.0, num_thresholds, device=pos.device)
    pred = (pos[None, :] > thr[:, None]).float()
    tpr = torch.sum(pred * lab[None], 1) / torch.clamp(torch.sum(lab),
                                                       min=1e-12)
    fpr = torch.sum(pred * (1 - lab[None]), 1) / torch.clamp(
        torch.sum(1 - lab), min=1e-12)
    order = torch.sort(tpr, stable=True).indices
    order = order[torch.sort(fpr[order], stable=True).indices]
    return torch.trapezoid(tpr[order], fpr[order])


class _PyFunc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, bwd, specs, *xs):
        ctx.bwd = bwd
        ctx.save_for_backward(*xs)
        out = fn(*[_host(v) for v in xs])
        outs = out if isinstance(out, (list, tuple)) else [out]
        dev = xs[0].device
        return tuple(torch.as_tensor(np.asarray(o, d), device=dev)
                     for o, (_, d) in zip(outs, specs))

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        if ctx.bwd is None:
            return (None, None, None) + (None,) * len(xs)
        got = ctx.bwd(*[_host(v) for v in xs], *[_host(g) for g in gs])
        got = got if isinstance(got, (list, tuple)) else [got]
        return (None, None, None) + tuple(
            torch.as_tensor(np.asarray(g, _host(x).dtype), device=x.device)
            for g, x in zip(got, xs))


def py_func(func, x, out_shapes=None, out_dtypes="float32",
            backward_func=None):
    """A host-Python op (reference py_func_op.cc): ``func`` (numpy in,
    numpy out) runs on the host copy of ``x``; the outputs, of
    ``out_shapes`` / ``out_dtypes`` (default: the first input's shape),
    land on the inputs' device. ``backward_func(inputs..., grads_out...)``
    gives the inputs' gradients."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    xs = [v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
          for v in xs]
    if out_shapes is None:
        out_shapes, single = [tuple(xs[0].shape)], True
    else:
        single = not isinstance(out_shapes[0], (list, tuple))
        out_shapes = [tuple(out_shapes)] if single \
            else [tuple(s) for s in out_shapes]
    if isinstance(out_dtypes, str):
        out_dtypes = [out_dtypes] * len(out_shapes)
    specs = [(s, np.dtype(str(to_torch_dtype(d)).replace("torch.", "")))
             for s, d in zip(out_shapes, out_dtypes)]
    outs = wrap(_PyFunc.apply(func, backward_func, specs, *xs))
    return outs[0] if single else outs


@defop
def tree_conv(nodes_vector, edge_set, filter, max_depth=2):  # noqa: A002
    """Tree-based convolution (reference tree_conv_op.cc, TBCNN's
    continuous binary tree): each node's window is itself and its direct
    children; the child at position j of k mixes the left and right
    matrices by eta_r = j / (k - 1). nodes_vector [B, n, d]; edge_set
    [B, e, 2] 1-based (parent, child), 0 padding; filter
    [d, 3, out, nf] (top, left, right). Returns [B, n, out, nf]."""
    x = nodes_vector
    b, n, _ = x.shape
    _, _, out_dim, nf = filter.shape
    wt, wl, wr = filter[:, 0], filter[:, 1], filter[:, 2]
    edges = edge_set.long()
    parent, child = edges[..., 0], edges[..., 1]
    valid = (parent > 0) & (child > 0)
    p_idx = torch.clamp(parent - 1, 0, n - 1)
    c_idx = torch.clamp(child - 1, 0, n - 1)
    one = valid.float()
    counts = torch.zeros((b, n), device=x.device).scatter_add(1, p_idx, one)
    # an edge's position among its parent's children: the earlier valid
    # edges with the same parent (the JAX op's running count)
    e = p_idx.shape[1]
    earlier = torch.tril(torch.ones(e, e, dtype=torch.bool,
                                    device=x.device), -1)
    same = (p_idx[:, :, None] == p_idx[:, None, :]) & earlier[None] \
        & valid[:, None, :]
    pos = same.float().sum(-1)
    k = torch.gather(counts, 1, p_idx)
    eta_r = torch.where(k > 1, pos / torch.clamp(k - 1.0, min=1.0),
                        torch.full_like(k, 0.5))
    eta_l = 1.0 - eta_r
    cx = torch.gather(x, 1, c_idx[..., None].expand(-1, -1, x.shape[2]))
    contrib = (torch.einsum("bed,dof->beof", cx, wl) * eta_l[..., None, None]
               + torch.einsum("bed,dof->beof", cx, wr)
               * eta_r[..., None, None])
    contrib = contrib * valid[..., None, None].to(contrib.dtype)
    acc = torch.zeros((b, n, out_dim, nf), dtype=contrib.dtype,
                      device=x.device)
    acc = acc.index_put(
        (torch.arange(b, device=x.device)[:, None].expand(b, e), p_idx),
        contrib, accumulate=True)
    return torch.tanh(acc + torch.einsum("bnd,dof->bnof", x, wt))
