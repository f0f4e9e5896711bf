"""Loss ops (paddle_tpu/ops/loss.py), every loss of the JAX module.

The CTC and CRF recursions (``ctc_loss`` / ``warpctc``,
``linear_chain_crf``, ``viterbi_decode``) are the JAX ops' log-space
alpha recursions, one step a time step in a Python loop over
``lax.scan``'s body, with the same ``NEG = -1e30`` for impossible
states and the same ``logsumexp`` (``_lse``: the max held out of the
gradient), so an infeasible CTC row (fewer frames than its labels need)
gives JAX's finite loss near 1e30 and JAX's gradient, where torch's
``F.ctc_loss`` gives inf. ``warpctc`` is JAX's: it passes ``blank`` on
and drops ``norm_by_times`` (the JAX op's signature; a reference
quirk). ``nce`` takes its negatives from the caller (``sample_ids``).
The recursions run in f32 from f16 / bf16 / f32 inputs, as the JAX ops
do; an f64 input stays f64 (the JAX ops cast it down to f32), so a host
run in f64 is a reference for the card's f32.

``cross_entropy`` with hard labels gathers the label's log-probability
(the JAX op multiplies by a one-hot; the sums are the same): a label
outside [0, C) selects no class (loss 0, and it still counts in "mean");
"mean" divides by the summed weights of the rows whose label is not
``ignore_index``.
"""
from __future__ import annotations

import torch

from ._dispatch import defop

__all__ = ["softmax_with_cross_entropy", "cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "sigmoid_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_similarity", "label_smooth", "square_error_cost",
           "log_loss", "triplet_margin_loss", "bpr_loss", "hinge_loss",
           "rank_loss", "modified_huber_loss",
           "teacher_student_sigmoid_loss", "npair_loss",
           "sigmoid_focal_loss", "kldiv_loss", "bce_loss", "ctc_loss",
           "warpctc", "linear_chain_crf", "viterbi_decode", "center_loss",
           "nce", "hsigmoid_loss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


def _hard_label(label, ndim, axis):
    if label.ndim == ndim and label.shape[axis] == 1:
        return torch.squeeze(label, axis)
    return label


def _pick(logp, label, axis):
    """logp's entry at ``label`` along ``axis`` (0 where the label is
    outside [0, C)) and the in-range mask."""
    n = logp.shape[axis]
    label = label.long()
    ok = torch.logical_and(torch.ge(label, 0), torch.lt(label, n))
    safe = torch.where(ok, label, torch.zeros_like(label))
    got = torch.take_along_dim(logp, torch.unsqueeze(safe, axis), dim=axis)
    got = torch.squeeze(got, axis)
    return torch.where(ok, got, torch.zeros_like(got)), ok


@defop
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    logp = torch.log_softmax(logits, axis)
    if soft_label:
        loss = torch.neg(torch.sum(torch.mul(label, logp), dim=axis,
                                   keepdim=True))
    else:
        lbl = _hard_label(label, logits.ndim, axis)
        valid = torch.ne(lbl, ignore_index)
        picked, _ = _pick(logp, torch.where(valid, lbl,
                                            torch.zeros_like(lbl)), axis)
        loss = torch.where(valid, torch.neg(picked),
                           torch.zeros_like(picked)).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, axis)
    return loss


@defop
def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    if use_softmax:
        logp = torch.log_softmax(input, axis)
    else:
        logp = torch.log(torch.clamp_min(input, 1e-30))
    n_classes = input.shape[axis]
    if soft_label:
        soft = label
        if label_smoothing > 0.0:
            soft = torch.add(torch.mul(soft, 1.0 - label_smoothing),
                             label_smoothing / n_classes)
        return _reduce(torch.neg(torch.sum(torch.mul(soft, logp), dim=axis)),
                       reduction)
    lbl = _hard_label(label, input.ndim, axis)
    picked, _ = _pick(logp, lbl, axis)
    if label_smoothing > 0.0:
        loss = torch.neg(torch.add(
            torch.mul(picked, 1.0 - label_smoothing),
            torch.mul(torch.sum(logp, dim=axis), label_smoothing / n_classes)))
    else:
        loss = torch.neg(picked)
    valid = torch.ne(lbl, ignore_index)
    if weight is not None:
        safe = torch.where(valid, lbl, torch.zeros_like(lbl)).long()
        w = torch.where(valid, torch.take(weight, safe),
                        torch.zeros((), dtype=weight.dtype,
                                    device=weight.device))
    else:
        w = valid.to(loss.dtype)
    loss = torch.mul(loss, w)
    if reduction == "mean":
        return torch.div(torch.sum(loss), torch.clamp_min(torch.sum(w), 1e-12))
    return _reduce(loss, reduction)


@defop
def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean"):
    valid = torch.ne(label, ignore_index)
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    picked = torch.neg(torch.take_along_dim(
        input, torch.unsqueeze(safe, -1), dim=-1).squeeze(-1))
    w = torch.take(weight, safe) if weight is not None \
        else torch.ones_like(picked)
    w = torch.where(valid, w, torch.zeros_like(w))
    picked = torch.mul(picked, w)
    if reduction == "mean":
        return torch.div(torch.sum(picked), torch.clamp_min(torch.sum(w),
                                                            1e-12))
    return _reduce(picked, reduction)


@defop
def mse_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.square(torch.sub(input, label)), reduction)


@defop
def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.abs(torch.sub(input, label)), reduction)


@defop
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    d = torch.sub(input, label)
    ad = torch.abs(d)
    loss = torch.where(torch.lt(ad, delta),
                       torch.div(torch.mul(torch.mul(d, d), 0.5), delta),
                       torch.sub(ad, 0.5 * delta))
    return _reduce(loss, reduction)


@defop
def huber_loss(input, label, delta=1.0):  # noqa: A002
    d = torch.sub(input, label)
    ad = torch.abs(d)
    return torch.where(torch.le(ad, delta), torch.mul(torch.mul(d, d), 0.5),
                       torch.mul(torch.sub(ad, 0.5 * delta), delta))


def _log_clamped(x, eps):
    return torch.log(torch.clamp_min(x, eps))


@defop
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    eps = 1e-12
    loss = torch.neg(torch.add(
        torch.mul(label, _log_clamped(input, eps)),
        torch.mul(torch.rsub(label, 1), _log_clamped(torch.rsub(input, 1),
                                                     eps))))
    if weight is not None:
        loss = torch.mul(loss, weight)
    return _reduce(loss, reduction)


def _sigmoid_ce(x, label):
    """max(x, 0) - x * label + log1p(exp(-|x|)), with the JAX package's
    subgradients at x = 0: ``maximum`` splits a tie (0.5 each side, as
    ``torch.maximum`` does; ``clamp_min`` would pass 1) and ``|x|`` has
    slope 1 there (``torch.abs`` has 0)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    abs_x = torch.where(torch.ge(x, 0), x, torch.neg(x))
    return torch.add(torch.sub(torch.maximum(x, zero), torch.mul(x, label)),
                     torch.log1p(torch.exp(torch.neg(abs_x))))


@defop
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    loss = _sigmoid_ce(logit, label)
    if pos_weight is not None:
        loss = torch.mul(loss, torch.add(torch.mul(torch.sub(pos_weight, 1.0),
                                                   label), 1.0))
    if weight is not None:
        loss = torch.mul(loss, weight)
    return _reduce(loss, reduction)


sigmoid_cross_entropy_with_logits = binary_cross_entropy_with_logits


@defop
def kl_div(input, label, reduction="mean"):  # noqa: A002
    loss = torch.mul(label, torch.sub(_log_clamped(label, 1e-30), input))
    if reduction == "batchmean":
        return torch.div(torch.sum(loss), input.shape[0])
    return _reduce(loss, reduction)


@defop
def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    loss = torch.clamp_min(torch.add(torch.neg(torch.mul(
        label, torch.sub(input, other))), margin), 0.0)
    return _reduce(loss, reduction)


@defop
def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(torch.eq(label, 1.0), input,
                       torch.clamp_min(torch.rsub(input, margin), 0.0))
    return _reduce(loss, reduction)


@defop
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(torch.mul(x1, x2), dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return torch.div(dot, torch.clamp_min(torch.mul(n1, n2), eps))


@defop
def label_smooth(label, prior_dist=None, epsilon=0.1):
    n = label.shape[-1]
    if prior_dist is not None:
        return torch.add(torch.mul(label, 1 - epsilon),
                         torch.mul(prior_dist, epsilon))
    return torch.add(torch.mul(label, 1 - epsilon), epsilon / n)


@defop
def square_error_cost(input, label):  # noqa: A002
    return torch.square(torch.sub(input, label))


@defop
def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    return torch.neg(torch.add(
        torch.mul(label, torch.log(torch.add(input, epsilon))),
        torch.mul(torch.rsub(label, 1),
                  torch.log(torch.add(torch.rsub(input, 1), epsilon)))))


def _pdist(a, b, p, epsilon):
    return torch.pow(torch.sum(torch.pow(torch.add(torch.abs(torch.sub(
        a, b)), epsilon), p), dim=-1), 1.0 / p)


@defop
def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, reduction="mean"):
    dp = _pdist(input, positive, p, epsilon)
    dn = _pdist(input, negative, p, epsilon)
    return _reduce(torch.clamp_min(torch.add(torch.sub(dp, dn), margin), 0.0),
                   reduction)


@defop
def bpr_loss(logits, label):
    lab = torch.reshape(label, (-1, 1)).long()
    pos = torch.take_along_dim(logits, lab, dim=1)
    loss = torch.neg(torch.nn.functional.logsigmoid(torch.sub(pos, logits)))
    mask = torch.ones_like(loss).scatter(1, lab, 0.0)
    return torch.div(torch.sum(torch.mul(loss, mask), dim=1, keepdim=True),
                     logits.shape[1] - 1)


@defop
def hinge_loss(logits, label):
    pm = torch.sub(torch.mul(label, 2.0), 1.0)
    return torch.clamp_min(torch.rsub(torch.mul(pm, logits), 1.0), 0.0)


@defop
def rank_loss(label, left, right):
    return _sigmoid_ce(torch.sub(left, right), label)


@defop
def modified_huber_loss(x, y):
    z = torch.mul(torch.sub(torch.mul(y, 2.0), 1.0), x)
    return torch.where(torch.lt(z, -1.0), torch.mul(z, -4.0),
                       torch.where(torch.lt(z, 1.0),
                                   torch.square(torch.rsub(z, 1.0)),
                                   torch.zeros_like(z)))


@defop
def teacher_student_sigmoid_loss(x, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    x = torch.clamp(x, soft_max_lower_bound, soft_max_up_bound)
    teacher = torch.gt(label, -1.0).to(x.dtype)
    return _sigmoid_ce(x, teacher)


@defop
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = torch.matmul(anchor, positive.T)
    lab = torch.reshape(labels, (-1,))
    same = torch.eq(lab[:, None], lab[None, :]).to(sim.dtype)
    tgt = torch.div(same, torch.sum(same, dim=1, keepdim=True))
    ce_r = torch.neg(torch.mean(torch.sum(torch.mul(
        tgt, torch.log_softmax(sim, 1)), dim=1)))
    ce_c = torch.neg(torch.mean(torch.sum(torch.mul(
        tgt, torch.log_softmax(sim.T, 1)), dim=1)))
    reg = torch.div(torch.mul(torch.add(
        torch.mean(torch.sum(torch.square(anchor), dim=1)),
        torch.mean(torch.sum(torch.square(positive), dim=1))), l2_reg), 2)
    return torch.add(torch.div(torch.add(ce_r, ce_c), 2), reg)


@defop
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0):
    p = torch.sigmoid(logit)
    ce = _sigmoid_ce(logit, label)
    p_t = torch.add(torch.mul(p, label),
                    torch.mul(torch.rsub(p, 1), torch.rsub(label, 1)))
    a_t = torch.add(torch.mul(label, alpha),
                    torch.mul(torch.rsub(label, 1), 1 - alpha))
    loss = torch.mul(torch.mul(a_t, torch.pow(torch.rsub(p_t, 1), gamma)), ce)
    if normalizer is not None:
        loss = torch.div(loss, normalizer)
    return loss


def kldiv_loss(x, target, reduction="mean"):
    return kl_div(x, target, reduction=reduction)


def bce_loss(input, label):  # noqa: A002
    return binary_cross_entropy(input, label, reduction="none")


# -- the recursions and the sampled losses ---------------------------------

NEG = -1e30


def _f32_up(x):
    """x in f32, or in f64 if it is f64."""
    return x if x.dtype == torch.float64 else x.float()


def _lse(x, dim):
    """``jax.scipy.special.logsumexp``: the max (0 where it is not finite)
    held out of the gradient, so a tie of impossible states splits its
    gradient evenly where torch.logsumexp's ``exp(x - result)`` would
    give each state 1."""
    m = torch.amax(x.detach(), dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.squeeze(
        torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True)) + m, dim)


@defop
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss (reference warpctc_op.cc): log_probs [T, B, C] logits
    (softmax inside, as warpctc), labels [B, S], the lengths [B]."""
    lp = torch.log_softmax(_f32_up(log_probs), -1)
    T, B, C = lp.shape
    S = labels.shape[1]
    L = 2 * S + 1
    dev = lp.device
    labels = labels.long()
    input_lengths = input_lengths.long()
    label_lengths = label_lengths.long()
    ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    skip_ok = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                         ext[:, 2:] != ext[:, :-2]], 1)
    # [B, L] a frame; unbind's backward stacks the frames' cotangents
    # once (indexing emits[t] would allocate a whole [T, B, L] each step)
    emits = torch.gather(lp, 2, ext[None].expand(T, B, L)).unbind(0)
    neg = torch.full((), NEG, dtype=lp.dtype, device=dev)
    alpha = torch.full((B, L), NEG, dtype=lp.dtype, device=dev)
    alpha = torch.cat([emits[0][:, :1], alpha[:, 1:]], 1)
    if S > 0:
        a1 = torch.where(label_lengths > 0, emits[0][:, 1], neg)
        alpha = torch.cat([alpha[:, :1], a1[:, None], alpha[:, 2:]], 1)
    pad1 = torch.full((B, 1), NEG, dtype=lp.dtype, device=dev)
    pad2 = torch.full((B, 2), NEG, dtype=lp.dtype, device=dev)
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], 1)
        prev2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], 1), neg)
        new = _lse(torch.stack([alpha, prev1, prev2]), 0) + emits[t]
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    idx_last = (2 * label_lengths)[:, None]
    idx_prev = torch.clamp(idx_last - 1, min=0)
    a_last = torch.gather(alpha, 1, idx_last)[:, 0]
    a_prev = torch.where(label_lengths > 0,
                         torch.gather(alpha, 1, idx_prev)[:, 0], neg)
    loss = -_lse(torch.stack([a_last, a_prev]), 0)
    if norm_by_times:
        loss = loss / torch.clamp(input_lengths.float(), min=1.0)
    if reduction == "mean":
        # warpctc's mean: each loss over its label length, then the batch
        return torch.mean(loss / torch.clamp(label_lengths.float(), min=1.0))
    return _reduce(loss, reduction)


def warpctc(logits, label, logits_length=None, labels_length=None,
            blank=0, norm_by_times=False):
    return ctc_loss(logits, label, logits_length, labels_length,
                    blank=blank)


def _crf_parts(emission, transition, length):
    em = _f32_up(emission)
    B, T, _ = em.shape
    tr = transition.to(em.dtype)
    if length is None:
        length = torch.full((B,), T, dtype=torch.long, device=em.device)
    return em, tr[0], tr[1], tr[2:], length.long()


@defop
def linear_chain_crf(emission, transition, label, length=None):
    """Linear-chain CRF negative log-likelihood [B] (reference
    linear_chain_crf_op.cc): emission [B, T, N], transition [N + 2, N]
    (start, stop, then from -> to), label [B, T], length [B] or None."""
    em, start, stop, trans, length = _crf_parts(emission, transition, length)
    B, T, _ = em.shape
    em_t = em.unbind(1)                   # one backward stack, not T
    alpha = start[None, :] + em_t[0]
    for t in range(1, T):
        new = _lse(alpha[:, :, None] + trans[None], 1) + em_t[t]
        alpha = torch.where((t < length)[:, None], new, alpha)
    log_z = _lse(alpha + stop[None, :], 1)
    label = label.long()
    br = torch.arange(B, device=em.device)
    gold = start[label[:, 0]] + em_t[0][br, label[:, 0]]
    for t in range(1, T):
        add = trans[label[:, t - 1], label[:, t]] + em_t[t][br, label[:, t]]
        gold = torch.where(t < length, gold + add, gold)
    last = torch.clamp(length - 1, 0, T - 1)
    return log_z - (gold + stop[label[br, last]])


@defop
def viterbi_decode(emission, transition, length=None):
    """CRF argmax decoding (reference crf_decoding_op.cc): (scores [B],
    paths [B, T] int64); a tie takes the lower tag, as ``jnp.argmax``."""
    em, start, stop, trans, length = _crf_parts(emission, transition, length)
    B, T, N = em.shape
    v = start[None, :] + em[:, 0]
    keep = torch.arange(N, device=em.device)[None, :].expand(B, N)
    bps = []
    for t in range(1, T):
        scores = v[:, :, None] + trans[None]             # [B, from, to]
        best, best_prev = torch.max(scores, 1)
        active = (t < length)[:, None]
        v = torch.where(active, best + em[:, t], v)
        bps.append(torch.where(active, best_prev, keep))
    final = v + stop[None, :]
    score, tag = torch.max(final, 1)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return score, torch.stack(path[::-1], 1).long()


@defop
def center_loss(features, label, centers, alpha=0.1, update_center=True):
    """reference center_loss_op.cc: (0.5 ||f - c_y||^2 [n, 1], the centers
    moved toward their class means at rate alpha)."""
    lab = label.reshape(-1).long()
    diff = features - centers[lab]
    loss = 0.5 * torch.sum(torch.square(diff), 1, keepdim=True)
    if update_center:
        k = centers.shape[0]
        num = torch.zeros_like(centers).index_add(0, lab, diff)
        cnt = torch.zeros((k,), dtype=centers.dtype,
                          device=centers.device).index_add(
            0, lab, torch.ones_like(lab, dtype=centers.dtype))
        centers = centers + alpha * num / (1.0 + cnt)[:, None]
    return loss, centers


@defop
def nce(input, label, weight, bias=None, sample_ids=None,  # noqa: A002
        num_neg_samples=5, num_total_classes=None):
    """Noise-contrastive estimation (reference nce_op.cc) over the
    caller's negatives ``sample_ids`` [num_neg]: [n, 1]."""
    lab = label.reshape(-1).long()
    if sample_ids is None:
        raise ValueError("nce: pass sample_ids (host-sampled negatives)")
    sid = sample_ids.reshape(-1).long()
    pos = torch.sum(input * weight[lab], 1, keepdim=True)
    neg = input @ weight[sid].T
    if bias is not None:
        pos = pos + bias[lab][:, None]
        neg = neg + bias[sid]
    logsig = torch.nn.functional.logsigmoid
    return -logsig(pos) - torch.sum(logsig(-neg), 1, keepdim=True)


@defop
def hsigmoid_loss(input, label, weight, bias=None,  # noqa: A002
                  num_classes=None):
    """Hierarchical sigmoid over the default complete binary tree
    (reference hierarchical_sigmoid_op.cc): class c's path is the binary
    expansion of c + num_classes in a heap layout. [n, 1]."""
    n_cls = int(num_classes)
    code_len = max(1, (n_cls - 1).bit_length())
    node = label.reshape(-1).long() + n_cls
    rows = weight.shape[0]
    total = 0
    for _ in range(code_len):
        parent = node // 2
        bit = (node % 2).to(input.dtype)
        live = (parent >= 1) & (parent - 1 < rows)
        w_idx = torch.clamp(parent - 1, 0, rows - 1)
        s = torch.sum(input * weight[w_idx], 1)
        if bias is not None:
            s = s + bias.reshape(-1)[w_idx]
        total = total + torch.where(live, _sigmoid_ce(s, bit),
                                    torch.zeros_like(s))
        node = parent
    return total[:, None]
