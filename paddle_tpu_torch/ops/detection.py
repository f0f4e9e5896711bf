"""Detection ops (paddle_tpu/ops/detection.py): 22 registry names.

The JAX module's split is kept. Dense geometry (``iou_similarity``,
``box_coder``, the anchor generators, ``yolo_box``, ``box_clip``,
``roi_align`` with its gradient, ``roi_pool``, ``target_assign``,
``box_decoder_and_assign``, ``mine_hard_examples``, ``yolov3_loss``)
runs on the tensors' device with static shapes, the jnp formulas op for
op. The selection ops, whose outputs have data-dependent sizes (``nms``,
``multiclass_nms``, ``matrix_nms``, ``bipartite_match``, the FPN
routing, ``generate_proposals``, ``retinanet_detection_output``), are the
JAX module's numpy host kernels (``_nms_np``), as the reference's
CPU-only kernels are: they read their inputs to the host and return
tensors on the inputs' device, so their results are the JAX ops' exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ._dispatch import defop, wrap

__all__ = ["iou_similarity", "box_coder", "prior_box", "yolo_box",
           "box_clip", "roi_align", "roi_pool", "nms", "multiclass_nms",
           "bipartite_match", "anchor_generator", "density_prior_box",
           "matrix_nms", "target_assign", "polygon_box_transform",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "box_decoder_and_assign", "mine_hard_examples", "yolov3_loss",
           "generate_proposals", "retinanet_detection_output"]


def _np(v):
    if isinstance(v, torch.Tensor):
        t = v.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(v)


def _dev(*vs):
    for v in vs:
        if isinstance(v, torch.Tensor):
            return v.device
    from ..device import resolve_device
    return resolve_device()


def _out(a, dev):
    return wrap(torch.as_tensor(np.ascontiguousarray(a), device=dev))


def _clip(x, lo=None, hi=None):
    """jnp.clip / jnp.maximum / jnp.minimum: a tie splits its gradient
    (torch.clamp passes all of it)."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _const(vals, like):
    return torch.as_tensor(np.asarray(vals), dtype=like.dtype,
                           device=like.device)


@defop
def iou_similarity(x, y, box_normalized=True):
    """[N, 4] x [M, 4] -> [N, M] IoU (reference iou_similarity_op.cc)."""
    off = 0.0 if box_normalized else 1.0
    ax1, ay1, ax2, ay2 = torch.split(x, 1, -1)
    bx1, by1, bx2, by2 = [v.T for v in torch.split(y, 1, -1)]
    iw = _clip(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + off, 0)
    ih = _clip(torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + off, 0)
    inter = iw * ih
    area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    return inter / _clip(area_a + area_b - inter, 1e-10)


@defop
def box_coder(prior_box_, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0):
    """reference box_coder_op.cc: encode / decode against the priors."""
    off = 0.0 if box_normalized else 1.0
    pw = prior_box_[:, 2] - prior_box_[:, 0] + off
    ph = prior_box_[:, 3] - prior_box_[:, 1] + off
    pcx = prior_box_[:, 0] + pw * 0.5
    pcy = prior_box_[:, 1] + ph * 0.5
    var = torch.ones((1, 4), dtype=target_box.dtype,
                     device=target_box.device) if prior_box_var is None \
        else prior_box_var.reshape(-1, 4)
    if code_type.startswith("encode"):
        tw = target_box[:, 2] - target_box[:, 0] + off
        th = target_box[:, 3] - target_box[:, 1] + off
        tcx = target_box[:, 0] + tw * 0.5
        tcy = target_box[:, 1] + th * 0.5
        out = torch.stack([(tcx[:, None] - pcx[None, :]) / pw[None, :],
                           (tcy[:, None] - pcy[None, :]) / ph[None, :],
                           torch.log(tw[:, None] / pw[None, :]),
                           torch.log(th[:, None] / ph[None, :])], -1)
        return out / var[None, :, :] if var.shape[0] > 1 else out / var
    t = target_box if target_box.ndim == 3 else target_box[:, None, :]
    v = var if var.shape[0] > 1 else torch.broadcast_to(var,
                                                        (pw.shape[0], 4))
    if axis == 0:
        pcx_, pcy_, pw_, ph_ = (a[None, :] for a in (pcx, pcy, pw, ph))
        v = v[None, :, :]
    else:
        pcx_, pcy_, pw_, ph_ = (a[:, None] for a in (pcx, pcy, pw, ph))
        v = v[:, None, :]
    cx = v[..., 0] * t[..., 0] * pw_ + pcx_
    cy = v[..., 1] * t[..., 1] * ph_ + pcy_
    w = torch.exp(v[..., 2] * t[..., 2]) * pw_
    h = torch.exp(v[..., 3] * t[..., 3]) * ph_
    out = torch.stack([cx - w * 0.5, cy - h * 0.5,
                       cx + w * 0.5 - off, cy + h * 0.5 - off], -1)
    return out.reshape(target_box.shape)


def _grid_centers(fh, fw, step_w, step_h, offset, like):
    cx = (torch.arange(fw, device=like.device) + offset) * step_w
    cy = (torch.arange(fh, device=like.device) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    return torch.stack([cxg, cyg], -1)[:, :, None, :]      # [fh, fw, 1, 2]


@defop
def prior_box(input, image, min_sizes, max_sizes=None,  # noqa: A002
              aspect_ratios=(1.0,), variances=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5):
    """reference prior_box_op.cc (SSD anchors)."""
    fh, fw = input.shape[-2], input.shape[-1]
    ih, iw = image.shape[-2], image.shape[-1]
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    whs = []
    for ms in min_sizes:
        for ar in ars:
            whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        for mx in max_sizes or ():
            whs.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    whs = torch.as_tensor(np.asarray(whs), dtype=torch.float32,
                          device=input.device)
    cxy = _grid_centers(fh, fw, step_w, step_h, offset, input)
    half = whs[None, None] * 0.5
    scale = torch.as_tensor([iw, ih], dtype=torch.float32,
                            device=input.device)
    boxes = torch.cat([(cxy - half) / scale, (cxy + half) / scale], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.broadcast_to(_const(variances, boxes), boxes.shape)
    return boxes, var


@defop
def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0):
    """reference yolo_box_op.cc: decode a YOLOv3 head [N, A*(5+C), H, W]
    into boxes [N, A*H*W, 4] and scores [N, A*H*W, C]."""
    n, _, h, w = x.shape
    na = len(anchors) // 2
    an = _const(anchors, x).reshape(na, 2)
    x = x.reshape(n, na, 5 + class_num, h, w)
    ar_w = torch.arange(w, device=x.device)[None, None, None, :]
    ar_h = torch.arange(h, device=x.device)[None, None, :, None]
    gx = (torch.sigmoid(x[:, :, 0]) * scale_x_y
          - (scale_x_y - 1) / 2 + ar_w) / w
    gy = (torch.sigmoid(x[:, :, 1]) * scale_x_y
          - (scale_x_y - 1) / 2 + ar_h) / h
    gw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] \
        / (downsample_ratio * w)
    gh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] \
        / (downsample_ratio * h)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    imh = img_size[:, 0].to(x.dtype)[:, None]
    imw = img_size[:, 1].to(x.dtype)[:, None]

    def flat(v):
        return v.reshape(n, -1)

    x1 = flat(gx - gw * 0.5) * imw
    y1 = flat(gy - gh * 0.5) * imh
    x2 = flat(gx + gw * 0.5) * imw
    y2 = flat(gy + gh * 0.5) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    mask = (flat(conf) > conf_thresh)[..., None].to(x.dtype)
    return boxes * mask, scores * mask


@defop
def box_clip(input, im_info):  # noqa: A002
    """reference box_clip_op.cc: clip boxes to the image."""
    h = im_info[..., 0:1] - 1
    w = im_info[..., 1:2] - 1
    zero = torch.zeros((), dtype=input.dtype, device=input.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi)

    out = torch.stack([clip(input[..., 0::4], w), clip(input[..., 1::4], h),
                       clip(input[..., 2::4], w), clip(input[..., 3::4], h)],
                      -1)
    return out.reshape(input.shape)


def _batch_index(boxes_num, r, device):
    if boxes_num is None:
        return torch.zeros((r,), dtype=torch.long, device=device)
    counts = torch.as_tensor(_np(boxes_num).astype(np.int64),
                             device=device)
    return torch.repeat_interleave(torch.arange(len(counts), device=device),
                                   counts, output_size=r)


def _interp_rows(p, size, bins, sr):
    """[R, bins, size]: each bin's mean over its ``sr`` samples ``p``
    [R, bins * sr] of the linear interpolation weights on the two
    neighbouring rows (clamped to the map, as the JAX op's taps)."""
    p0 = _clip(torch.floor(p), 0, size - 1)
    p1 = _clip(p0 + 1, 0, size - 1)
    w = _clip(p, 0, size - 1) - p0
    r = p.shape[0]
    idx = torch.stack([p0, p1], -1).long().reshape(r, bins, 2 * sr)
    wt = (torch.stack([1 - w, w], -1) / sr).reshape(r, bins, 2 * sr)
    return torch.zeros((r, bins, size), dtype=p.dtype,
                       device=p.device).scatter_add(2, idx, wt)


@defop
def roi_align(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """reference roi_align_op.cc: bilinear RoI pooling, differentiable.
    x: [N,C,H,W]; boxes: [R,4] (x1,y1,x2,y2) on image scale; boxes_num:
    rois per batch image (None => all on image 0). A sampling ratio of -1
    takes 2 samples a bin side, as the JAX op.

    The bilinear taps of a bin's samples are separable, so each image's
    RoIs are two matrix products with its map: the rows' weights [R, oh,
    H] (each bin's mean over its samples of the two-row interpolation),
    the map, the columns' weights [R, ow, W]. The same sums as the JAX
    op's gather of four taps a sample, without a scatter of the map's
    gradient (at R-CNN sizes, 512 RoIs of 14 x 14 over [1024, 50, 76],
    the gather's backward takes seconds on the card)."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    n, c, H, W = x.shape
    r = boxes.shape[0]
    counts = [r] if boxes_num is None \
        else [int(k) for k in _np(boxes_num).reshape(-1)]
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    rw = _clip(boxes[:, 2] * spatial_scale - off - x1,
               1e-3 if aligned else 1.0)
    rh = _clip(boxes[:, 3] * spatial_scale - off - y1,
               1e-3 if aligned else 1.0)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    gy = torch.arange(oh * sr, device=x.device, dtype=boxes.dtype)
    gx = torch.arange(ow * sr, device=x.device, dtype=boxes.dtype)
    ys = y1[:, None] + rh[:, None] * (gy + 0.5) / (oh * sr)   # [R, oh*sr]
    xs = x1[:, None] + rw[:, None] * (gx + 0.5) / (ow * sr)   # [R, ow*sr]
    wy = _interp_rows(ys, H, oh, sr).to(x.dtype)             # [R, oh, H]
    wx = _interp_rows(xs, W, ow, sr).to(x.dtype)             # [R, ow, W]
    outs = []
    for img, (a, b) in enumerate(zip(torch.split(wy, counts),
                                     torch.split(wx, counts))):
        if a.shape[0]:
            t = torch.einsum("rih,chw->rciw", a, x[img])
            outs.append(torch.einsum("rciw,rjw->rcij", t, b))
    return torch.cat(outs) if outs else x.new_zeros((0, c, oh, ow))


@defop
def roi_pool(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0):
    """reference roi_pool_op.cc: max over quantized RoI bins (an 8 x 8
    sample lattice a bin, as the JAX op)."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    _, c, H, W = x.shape
    r = boxes.shape[0]
    bi = _batch_index(boxes_num, r, x.device)
    q = [torch.round(boxes[:, k] * spatial_scale).long() for k in range(4)]
    x1, y1, x2, y2 = q
    SR = 8
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    ys = torch.clamp(y1[:, None] + torch.div(
        torch.arange(oh * SR, device=x.device)[None] * rh[:, None],
        oh * SR, rounding_mode="floor"), 0, H - 1)
    xs = torch.clamp(x1[:, None] + torch.div(
        torch.arange(ow * SR, device=x.device)[None] * rw[:, None],
        ow * SR, rounding_mode="floor"), 0, W - 1)
    vals = x[bi[:, None, None], :, ys[:, :, None], xs[:, None, :]]
    vals = vals.permute(0, 3, 1, 2).reshape(r, c, oh, SR, ow, SR)
    return torch.amax(vals, (3, 5))


# -- host-side selection kernels --------------------------------------------

def _nms_np(boxes, scores, threshold, top_k=-1, eta=1.0):
    """Greedy NMS; eta < 1 is the reference's adaptive mode."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if top_k > 0 and len(keep) >= top_k:
            break
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-10)
        suppressed |= iou > threshold
        if eta < 1.0 and threshold > 0.5:
            threshold *= eta
    return np.asarray(keep, np.int64)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """reference nms_op: the kept box indices (a host kernel)."""
    dev = _dev(boxes, scores)
    b = _np(boxes)
    s = _np(scores) if scores is not None \
        else np.arange(len(b), 0, -1, dtype=np.float32)
    if category_idxs is not None:
        cats = _np(category_idxs)
        keep_all = []
        for cval in (categories if categories is not None
                     else np.unique(cats)):
            idx = np.nonzero(cats == cval)[0]
            keep_all.append(idx[_nms_np(b[idx], s[idx], iou_threshold)])
        keep = np.concatenate(keep_all) if keep_all \
            else np.zeros(0, np.int64)
        keep = keep[np.argsort(-s[keep])]
    else:
        keep = _nms_np(b, s, iou_threshold)
    if top_k is not None:
        keep = keep[:top_k]
    return _out(keep, dev)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=400,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   background_label=0):
    """reference multiclass_nms_op.cc: per-class NMS, then the global
    keep_top_k. bboxes [N, M, 4]; scores [N, C, M]. (out [K, 6] of
    label, score, x1, y1, x2, y2; rois_num [N] int32)."""
    dev = _dev(bboxes, scores)
    b, s = _np(bboxes), _np(scores)
    outs, nums = [], []
    for n in range(b.shape[0]):
        dets = []
        for c in range(s.shape[1]):
            if c == background_label:
                continue
            sc = s[n, c]
            idx = np.nonzero(sc > score_threshold)[0]
            if not idx.size:
                continue
            order = idx[np.argsort(-sc[idx])][:nms_top_k]
            kept = _nms_np(b[n][order], sc[order], nms_threshold)
            for i in order[kept]:
                dets.append([c, sc[i], *b[n, i]])
        dets.sort(key=lambda d: -d[1])
        dets = dets[:keep_top_k]
        outs.extend(dets)
        nums.append(len(dets))
    return (_out(np.asarray(outs, np.float32).reshape(-1, 6), dev),
            _out(np.asarray(nums, np.int32), dev))


def bipartite_match(dist_mat):
    """reference bipartite_match_op.cc: greedy matching by the global max
    entry. (match_indices [M] int64, match_dist [M] f32) over columns."""
    dev = _dev(dist_mat)
    d = np.array(_np(dist_mat), copy=True)
    n, m = d.shape
    match_idx = np.full(m, -1, np.int64)
    match_dist = np.zeros(m, np.float32)
    for _ in range(min(n, m)):
        i, j = np.unravel_index(np.argmax(d), d.shape)
        if d[i, j] <= 0:
            break
        match_idx[j] = i
        match_dist[j] = d[i, j]
        d[i, :] = -1
        d[:, j] = -1
    return _out(match_idx, dev), _out(match_dist, dev)


@defop
def anchor_generator(input, anchor_sizes, aspect_ratios,  # noqa: A002
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5):
    """reference anchor_generator_op.cc (Faster R-CNN RPN anchors):
    [fh, fw, A, 4] xyxy in input-image pixels, and the variances."""
    fh, fw = input.shape[-2], input.shape[-1]
    whs = []
    for s in anchor_sizes:
        for ar in aspect_ratios:
            w = np.sqrt(float(s) * float(s) / ar)
            whs.append((w, w * ar))
    whs = torch.as_tensor(np.asarray(whs), dtype=torch.float32,
                          device=input.device)
    cxy = _grid_centers(fh, fw, stride[0], stride[1], offset, input)
    half = whs[None, None] * 0.5
    anchors = torch.cat([cxy - half, cxy + half], -1)
    return anchors, torch.broadcast_to(_const(variances, anchors),
                                       anchors.shape)


@defop
def density_prior_box(input, image, densities, fixed_sizes,  # noqa: A002
                      fixed_ratios, variances=(0.1, 0.1, 0.2, 0.2),
                      steps=(0.0, 0.0), offset=0.5, clip=False):
    """reference density_prior_box_op.cc: density^2 shifted centers per
    (density, fixed size, ratio)."""
    fh, fw = input.shape[-2], input.shape[-1]
    ih, iw = image.shape[-2], image.shape[-1]
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh
    cells = []
    for density, size in zip(densities, fixed_sizes):
        for ratio in fixed_ratios:
            w, h = size * np.sqrt(ratio), size / np.sqrt(ratio)
            sw, sh = step_w / density, step_h / density
            for di in range(density):
                for dj in range(density):
                    cells.append((dj * sw + sw / 2 - step_w / 2,
                                  di * sh + sh / 2 - step_h / 2, w, h))
    spec = torch.as_tensor(np.asarray(cells), dtype=torch.float32,
                           device=input.device)
    ctr = _grid_centers(fh, fw, step_w, step_h, offset, input) \
        + spec[None, None, :, :2]
    half = spec[None, None, :, 2:] * 0.5
    scale = torch.as_tensor([iw, ih], dtype=torch.float32,
                            device=input.device)
    out = torch.cat([(ctr - half) / scale, (ctr + half) / scale], -1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out, torch.broadcast_to(_const(variances, out), out.shape)


def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0):
    """reference matrix_nms_op.cc (SOLOv2's parallel soft-NMS), a host
    kernel: bboxes [N, 4], scores [C, N] -> (out [n, 6], indices)."""
    dev = _dev(bboxes, scores)
    bboxes, scores = _np(bboxes), _np(scores)
    outs, idxs = [], []
    for c in range(scores.shape[0]):
        s = scores[c]
        keep = np.where(s > score_threshold)[0]
        if keep.size == 0:
            continue
        order = keep[np.argsort(-s[keep])][:nms_top_k]
        b, sv = bboxes[order], s[order]
        x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        iw = np.maximum(np.minimum(x2[:, None], x2[None])
                        - np.maximum(x1[:, None], x1[None]), 0)
        ih = np.maximum(np.minimum(y2[:, None], y2[None])
                        - np.maximum(y1[:, None], y1[None]), 0)
        inter = iw * ih
        iou = np.triu(inter / np.maximum(area[:, None] + area[None] - inter,
                                         1e-10), 1)
        iou_max = iou.max(axis=0)
        comp = iou.max(axis=1, initial=0)
        if use_gaussian:
            decay = np.exp(-(iou_max ** 2 - comp ** 2) / gaussian_sigma)
        else:
            decay = (1 - iou_max) / np.maximum(1 - comp, 1e-10)
        decayed = sv * np.minimum(decay, 1.0)
        for i in np.where(decayed > post_threshold)[0]:
            outs.append([c, decayed[i], *b[i]])
            idxs.append(order[i])
    if not outs:
        return _out(np.zeros((0, 6), np.float32), dev), \
            _out(np.zeros((0,), np.int64), dev)
    outs = np.asarray(outs, np.float32)
    idxs = np.asarray(idxs, np.int64)
    order = np.argsort(-outs[:, 1])[:keep_top_k]
    return _out(outs[order], dev), _out(idxs[order], dev)


@defop
def target_assign(x, match_indices, mismatch_value=0):
    """reference target_assign_op.cc: per prior, the matched gt row (-1:
    ``mismatch_value``, weight 0). x [N, G, K] -> (out [N, M, K],
    weights [N, M, 1])."""
    mi = match_indices.long()
    out = torch.gather(x, 1, torch.clamp(mi, min=0)[:, :, None].expand(
        -1, -1, x.shape[2]))
    matched = (mi >= 0)[:, :, None]
    out = torch.where(matched, out, torch.as_tensor(
        mismatch_value, dtype=out.dtype, device=out.device))
    return out, matched.to(x.dtype)


@defop
def polygon_box_transform(input):  # noqa: A002
    """reference polygon_box_transform_op.cc (EAST): 4 * grid - offset,
    the even channels against x, the odd against y."""
    _, c, h, w = input.shape
    xs = torch.arange(w, dtype=input.dtype, device=input.device)
    ys = torch.arange(h, dtype=input.dtype, device=input.device)
    even = (torch.arange(c, device=input.device) % 2 == 0)[None, :, None,
                                                          None]
    grid = torch.where(even, xs[None, None, None, :].expand(1, 1, h, w),
                       ys[None, None, :, None].expand(1, 1, h, w))
    return 4.0 * grid - input


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale):
    """reference distribute_fpn_proposals_op.cc: each RoI to its pyramid
    level by the sqrt-area rule (a host kernel); (rois per level,
    restore index)."""
    dev = _dev(fpn_rois)
    rois = _np(fpn_rois)
    w = np.maximum(rois[:, 2] - rois[:, 0], 0)
    h = np.maximum(rois[:, 3] - rois[:, 1], 0)
    lvl = np.floor(np.log2(np.sqrt(w * h) / refer_scale + 1e-8)) \
        + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(int)
    outs, order = [], []
    for level in range(min_level, max_level + 1):
        idx = np.where(lvl == level)[0]
        order.append(idx)
        outs.append(_out(rois[idx], dev))
    order = np.concatenate(order) if order else np.zeros((0,), int)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    return outs, _out(restore.astype(np.int64), dev)


def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n):
    """reference collect_fpn_proposals_op.cc: the global top-n RoIs of all
    levels by score (a host kernel)."""
    dev = _dev(*multi_rois)
    rois = np.concatenate([_np(r) for r in multi_rois], 0)
    scores = np.concatenate([_np(s).reshape(-1) for s in multi_scores], 0)
    return _out(rois[np.argsort(-scores)[:post_nms_top_n]], dev)


@defop
def box_decoder_and_assign(prior_box_, prior_box_var, target_box,
                           box_score, box_clip_value=4.135):
    """reference box_decoder_and_assign_op.cc (Cascade R-CNN): decode each
    class's deltas, then give each prior its best class's box."""
    n = prior_box_.shape[0]
    c = box_score.shape[1]
    pw = prior_box_[:, 2] - prior_box_[:, 0]
    ph = prior_box_[:, 3] - prior_box_[:, 1]
    pcx = prior_box_[:, 0] + pw * 0.5
    pcy = prior_box_[:, 1] + ph * 0.5
    t = torch.reshape(target_box, (n, c, 4))
    var = torch.reshape(prior_box_var, (-1, 4))
    dw = _clip(t[:, :, 2] * var[:, 2:3], -box_clip_value, box_clip_value)
    dh = _clip(t[:, :, 3] * var[:, 3:4], -box_clip_value, box_clip_value)
    cx = pcx[:, None] + t[:, :, 0] * var[:, 0:1] * pw[:, None]
    cy = pcy[:, None] + t[:, :, 1] * var[:, 1:2] * ph[:, None]
    w = torch.exp(dw) * pw[:, None]
    h = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          -1)
    best = torch.argmax(box_score, 1)
    assigned = torch.gather(decoded, 1, best[:, None, None].expand(
        -1, 1, 4))[:, 0]
    return torch.reshape(decoded, (n, c * 4)), assigned


@defop
def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0,
                       mining_type="max_negative"):
    """reference mine_hard_examples_op.cc (SSD's OHEM): a 0/1 int32 mask
    over [N, M] of the highest-loss negatives, ratio x positives each."""
    neg = match_indices < 0
    n_pos = torch.sum(~neg, 1, keepdim=True)
    quota = torch.ceil(neg_pos_ratio * n_pos).to(torch.int64)
    masked = torch.where(neg, cls_loss, torch.full_like(cls_loss,
                                                        -torch.inf))
    order = torch.argsort(-masked, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return (neg & (rank < quota)).to(torch.int32)


@defop
def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh=0.7, downsample_ratio=32,
                use_label_smooth=False):
    """reference yolov3_loss_op.cc in the JAX op's simplified form: the
    targets of the gt boxes whose best anchor is in ``anchor_mask``,
    coordinate + objectness + class BCE, and the no-object term over all
    cells (``ignore_thresh`` is taken and unused, as in the JAX op).
    x [N, A*(5+C), H, W]; gt_box [N, B, 4] (cx, cy, w, h relative);
    gt_label [N, B]. Returns [N]. The JAX op loops over the B gt boxes;
    here each anchor of the mask takes all B cells in one gather (the
    terms are the same, summed over the boxes in another order)."""
    n, _, h, w = x.shape
    a = len(anchor_mask)
    c = int(class_num)
    xr = torch.reshape(x, (n, a, 5 + c, h, w))
    cells = xr.permute(0, 1, 3, 4, 2).reshape(n, a, h * w, 5 + c)
    all_anchors = [(anchors[2 * i], anchors[2 * i + 1])
                   for i in range(len(anchors) // 2)]
    in_w, in_h = w * float(downsample_ratio), h * float(downsample_ratio)
    gx, gy, gw, gh = gt_box.float().unbind(-1)               # [N, B]
    valid = (gw > 0) & (gh > 0)
    ious = []
    for aw, ah in all_anchors:
        inter = _clip(gw * in_w, hi=aw) * _clip(gh * in_h, hi=ah)
        union = gw * in_w * gh * in_h + aw * ah - inter
        ious.append(inter / _clip(union, 1e-10))
    best = torch.argmax(torch.stack(ious), 0)                # [N, B]
    gi = torch.clamp((gx * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gy * h).to(torch.int32), 0, h - 1).long()
    tx, ty = gx * w - gi, gy * h - gj
    onehot = torch.nn.functional.one_hot(gt_label.long(), c).float()
    if use_label_smooth:
        onehot = onehot * (1 - 1.0 / c) + 1.0 / c * (1 - onehot)
    bidx = torch.arange(n, device=x.device)[:, None].expand_as(gi)
    logsig = torch.nn.functional.logsigmoid
    total = torch.zeros((n,), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for mi, src in enumerate(anchor_mask):
        aw, ah = anchors[2 * src], anchors[2 * src + 1]
        tw = torch.log(torch.clamp(gw * in_w / aw, min=1e-9))
        th = torch.log(torch.clamp(gh * in_h / ah, min=1e-9))
        cell = cells[bidx, mi, gj * w + gi]                  # [N, B, 5+C]
        pxy = torch.sigmoid(cell[..., 0:2])
        pwh, pob, pcl = cell[..., 2:4], cell[..., 4], cell[..., 5:]
        coord = (torch.square(pxy[..., 0] - tx) + torch.square(pxy[..., 1] - ty)
                 + torch.square(pwh[..., 0] - tw)
                 + torch.square(pwh[..., 1] - th)) * (2.0 - gw * gh)
        cls = torch.sum(_clip(pcl, 0) - pcl * onehot
                        + torch.log1p(torch.exp(-torch.abs(pcl))), -1)
        term = coord - logsig(pob) + cls
        total = total + torch.sum(torch.where(valid & (best == src), term,
                                              zero), 1)
    noobj = -logsig(-xr[:, :, 4])
    return total + torch.sum(noobj, (1, 2, 3)) / (a * h * w)


def generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=True, return_rois_num=False):
    """reference generate_proposals_op.cc: RPN decode -> clip -> min size
    -> top-k -> NMS -> top post_nms, per image (a host kernel).
    (rois [R, 4], roi_probs [R, 1]) (+ rois_num [N] when asked)."""
    dev = _dev(scores, bbox_deltas)
    sc, bd = _np(scores), _np(bbox_deltas)
    anc = _np(anchors).reshape(-1, 4).astype(np.float64)
    var = _np(variances).reshape(-1, 4).astype(np.float64)
    ims = _np(im_shape)
    n, a, h, w = sc.shape
    offset = 1.0 if pixel_offset else 0.0
    all_rois, all_probs, nums = [], [], []
    for i in range(n):
        s = sc[i].transpose(1, 2, 0).reshape(-1)
        d = bd[i].reshape(a, 4, h, w).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, anc_i, var_i = s[order], d[order], anc[order], var[order]
        aw = anc_i[:, 2] - anc_i[:, 0] + offset
        ah = anc_i[:, 3] - anc_i[:, 1] + offset
        acx, acy = anc_i[:, 0] + aw * 0.5, anc_i[:, 1] + ah * 0.5
        dx, dy, dw, dh = (d * var_i).T
        cx, cy = dx * aw + acx, dy * ah + acy
        bw = np.exp(np.minimum(dw, np.log(1000.0 / 16))) * aw
        bh = np.exp(np.minimum(dh, np.log(1000.0 / 16))) * ah
        boxes = np.stack([cx - bw * 0.5, cy - bh * 0.5,
                          cx + bw * 0.5 - offset, cy + bh * 0.5 - offset], 1)
        imh, imw = float(ims[i][0]), float(ims[i][1])
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, imw - offset)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, imh - offset)
        keep_sz = ((boxes[:, 2] - boxes[:, 0] + offset >= min_size)
                   & (boxes[:, 3] - boxes[:, 1] + offset >= min_size))
        boxes, s = boxes[keep_sz], s[keep_sz]
        keep = _nms_np(boxes, s, nms_thresh, top_k=post_nms_top_n, eta=eta)
        all_rois.append(boxes[keep])
        all_probs.append(s[keep, None])
        nums.append(len(keep))
    rois = np.concatenate(all_rois) if all_rois else np.zeros((0, 4))
    probs = np.concatenate(all_probs) if all_probs else np.zeros((0, 1))
    out = (_out(rois.astype(np.float32), dev),
           _out(probs.astype(np.float32), dev))
    if return_rois_num:
        out += (_out(np.asarray(nums, np.int32), dev),)
    return out


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.45,
                               nms_eta=1.0):
    """reference retinanet_detection_output_op.cc: decode each FPN level's
    predictions and run class-wise NMS (a host kernel)."""
    def as_list(v):
        return list(v) if isinstance(v, (list, tuple)) else [v]

    box_l = [_np(b) for b in as_list(bboxes)]
    sc_l = [_np(s) for s in as_list(scores)]
    anc_l = [_np(a).reshape(-1, 4) for a in as_list(anchors)]
    dev = _dev(*as_list(bboxes))
    outs = []
    for i in range(box_l[0].shape[0]):
        dets_boxes, dets_scores = [], []
        for bx, scl, anc in zip(box_l, sc_l, anc_l):
            d = bx[i].reshape(-1, 4)
            aw = anc[:, 2] - anc[:, 0] + 1
            ah = anc[:, 3] - anc[:, 1] + 1
            acx, acy = anc[:, 0] + aw * 0.5, anc[:, 1] + ah * 0.5
            cx, cy = d[:, 0] * aw + acx, d[:, 1] * ah + acy
            bw, bh = np.exp(d[:, 2]) * aw, np.exp(d[:, 3]) * ah
            dets_boxes.append(np.stack([cx - bw * 0.5, cy - bh * 0.5,
                                        cx + bw * 0.5 - 1,
                                        cy + bh * 0.5 - 1], 1))
            dets_scores.append(scl[i].reshape(d.shape[0], -1))
        boxes = np.concatenate(dets_boxes)
        scs = np.concatenate(dets_scores)
        results = []
        for c in range(scs.shape[1]):
            mask = scs[:, c] > score_threshold
            if not mask.any():
                continue
            bsel, ssel = boxes[mask], scs[mask, c]
            order = np.argsort(-ssel)[:nms_top_k]
            keep = _nms_np(bsel[order], ssel[order], nms_threshold,
                           eta=nms_eta)
            for j in keep:
                results.append([c, ssel[order][j], *bsel[order][j]])
        outs.append(np.asarray(sorted(results, key=lambda r: -r[1])
                               [:keep_top_k], np.float32).reshape(-1, 6))
    out = np.concatenate(outs) if outs else np.zeros((0, 6), np.float32)
    return _out(out, dev)
