"""The long tail's paths, whole, at a small size, against the JAX package
(chip_smoke.py phase 28 runs them at full width on the card):

- a tiny BERT with a CRF head (a 7-tag emission Linear and a [9, 7]
  transition) trained by ``Model.fit``, then ``viterbi_decode`` and
  ``ChunkEvaluator`` (IOB, 3 chunk types) on a batch: the step losses at
  rtol 1e-4 (f32, an attention and a CRF in another summation order), the
  paths and the chunk counts exactly;
- CTC at a small ASR shape with an infeasible row: ``ctc_loss`` forward
  and backward and ``warpctc`` at rtol 1e-4, the greedy decode's
  ``EditDistance`` exactly;
- detection: ``yolo_box`` over three grids, ``multiclass_nms``, and
  ``DetectionMAP`` (VOC 11-point) over the kept boxes, the kept boxes and
  the mAP exactly; ``roi_align`` forward and backward at 1e-5.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.text.models.bert import Bert as JBert
from paddle_tpu.text.models.bert import BertConfig as JBertConfig
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.text.models import Bert, BertConfig

NUM_TAGS, B, S = 7, 4, 12


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _crf_model(pkg, bert):
    class BertCRF(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = bert
            self.emit = pkg.nn.Linear(bert.config.hidden_size, NUM_TAGS)
            self.transition = self.create_parameter([NUM_TAGS + 2, NUM_TAGS])

        def emissions(self, ids):
            return self.emit(self.bert(ids))

        def forward(self, ids, tags):
            return pkg.ops.mean(pkg.ops.linear_chain_crf(
                self.emissions(ids), self.transition, tags))
    return BertCRF()


def _bert_crf_pair():
    jc, tc = JBertConfig.tiny(), BertConfig.tiny()
    for c in (jc, tc):
        c.hidden_dropout_prob = c.attention_probs_dropout_prob = 0.0
    jp.seed(0)
    jnet = _crf_model(jp, JBert(jc, with_mlm=False))
    tnet = _crf_model(tp, Bert(tc, with_mlm=False, device="cpu"))
    rs = np.random.RandomState(1)
    params = {k: np.asarray(v) for k, v in
              jnet.functional_state()[0].items()}
    params["transition"] = rs.uniform(-0.5, 0.5, (NUM_TAGS + 2, NUM_TAGS)) \
        .astype(np.float32)
    jnet.transition.set_value(params["transition"])
    load_jax_params(tnet, params)
    return jnet, tnet


def _tags(rs, n):
    """BIO tags of PER / ORG / LOC (B = 2k, I = 2k + 1) and O = 6: chunks
    of 1-3 tokens at random starts."""
    tags = np.full((n, S), 6, np.int64)
    for r in range(n):
        pos = 0
        while pos < S:
            pos += rs.randint(0, 3)
            if pos >= S:
                break
            k, ln = rs.randint(0, 3), rs.randint(1, 4)
            tags[r, pos] = 2 * k
            tags[r, pos + 1:pos + ln] = 2 * k + 1
            pos += ln
    return tags


def test_bert_crf_fit_then_viterbi_and_chunk_counts_match_jax():
    jnet, tnet = _bert_crf_pair()
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 1024, (2 * B, S)).astype(np.int64)
    tags = _tags(rs, 2 * B)
    losses = {}
    for pkg, net in ((jp, jnet), (tp, tnet)):
        class Rec(pkg.hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                losses.setdefault(pkg, []).append(float(logs["loss"]))
        model = pkg.Model(net, inputs=[None, None])
        model.prepare(pkg.optimizer.SGD(learning_rate=0.01,
                                        parameters=net.parameters()),
                      loss=lambda loss: loss)
        model.fit(pkg.io.TensorDataset([ids, tags]), batch_size=B,
                  epochs=2, verbose=0, shuffle=False, callbacks=[Rec()])
    assert len(losses[tp]) == 4
    np.testing.assert_allclose(losses[tp], losses[jp], rtol=1e-4)
    assert losses[tp][2] < losses[tp][0]     # batch 0, epochs 1 and 2
    out = {}
    for pkg, net in ((jp, jnet), (tp, tnet)):
        with (torch.no_grad() if pkg is tp else jp.no_grad()):
            em = net.emissions(pkg.to_tensor(ids[:B]))
            score, path = pkg.ops.viterbi_decode(em, net.transition)
        ev = pkg.metric.ChunkEvaluator(num_chunk_types=3)
        ev.update(path, pkg.to_tensor(tags[:B]))
        out[pkg] = (np.asarray(score.numpy()), np.asarray(path.numpy()),
                    (ev.num_infer, ev.num_label, ev.num_correct))
    np.testing.assert_allclose(out[tp][0], out[jp][0], rtol=1e-4)
    np.testing.assert_array_equal(out[tp][1], out[jp][1])
    assert out[tp][2] == out[jp][2]


def _greedy(logits, lens, blank=0):
    """Argmax per frame, repeats collapsed, blanks dropped."""
    best = logits.argmax(-1).T                      # [B, T]
    out = []
    for b, n in enumerate(lens):
        seq = best[b, :n]
        keep = np.concatenate([[True], seq[1:] != seq[:-1]]) & (seq != blank)
        out.append(seq[keep])
    return out


def test_ctc_path_matches_jax():
    rs = np.random.RandomState(3)
    T, n, C, L = 40, 4, 6, 10
    logits = (rs.randn(T, n, C) * 2).astype(np.float32)
    labels = rs.randint(1, C, (n, L)).astype(np.int64)
    il = np.array([40, 33, 28, 8], np.int64)     # row 3 infeasible
    ll = np.array([10, 7, 9, 10], np.int64)
    res = {}
    for pkg in (jp, tp):
        # the JAX op with x64 off, as on its TPU: see test_torch_ctc_crf.py's
        # test_known_difference_x64_splits_an_infeasible_rows_gradient
        ctx = jax.enable_x64(False) if pkg is jp else contextlib.nullcontext()
        with ctx:
            res[pkg] = _ctc_path(pkg, logits, labels, il, ll)
    (jl, jg, jw, je), (tl, tg, tw, te) = res[jp], res[tp]
    assert tl[3] > 1e29 and np.isfinite(tg).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=1e-5)
    assert te == je


def _ctc_path(pkg, logits, labels, il, ll):
    x = pkg.to_tensor(logits, stop_gradient=False)
    args = [pkg.to_tensor(a) for a in (labels, il, ll)]
    loss = pkg.ops.ctc_loss(x, *args, reduction="none")
    loss.sum().backward()
    warp = pkg.ops.warpctc(pkg.to_tensor(logits), *args,
                           norm_by_times=True)
    hyps = _greedy(logits, il)
    ev = pkg.metric.EditDistance()
    for h, r, k in zip(hyps, labels, ll):
        ev.update([h], [r[:k]])
    return (np.asarray(loss.numpy()), np.asarray(x.grad.numpy()),
            float(np.asarray(warp.numpy())), ev.accumulate())


ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
           198, 373, 326]


def _detect(pkg, heads, img):
    boxes, scores = [], []
    for g, (x, mask) in enumerate(heads):
        an = [ANCHORS[2 * i + k] for i in mask for k in (0, 1)]
        b, s = pkg.ops.yolo_box(pkg.to_tensor(x), pkg.to_tensor(img), an, 4,
                                conf_thresh=0.005,
                                downsample_ratio=32 // 2 ** g)
        boxes.append(b)
        scores.append(s)
    b = pkg.ops.concat(boxes, axis=1)
    s = pkg.ops.transpose(pkg.ops.concat(scores, axis=1), [0, 2, 1])
    return pkg.ops.multiclass_nms(b, s, score_threshold=0.005,
                                  nms_top_k=100, keep_top_k=20,
                                  nms_threshold=0.45, background_label=-1)


def test_detection_path_ends_in_the_same_map_as_jax():
    rs = np.random.RandomState(4)
    n = 2
    heads = [((rs.randn(n, 3 * 9, g, g) * 2).astype(np.float32), mask)
             for g, mask in ((2, (6, 7, 8)), (4, (3, 4, 5)), (8, (0, 1, 2)))]
    img = np.array([[64, 64], [64, 48]], np.int32)
    out = {pkg: _detect(pkg, heads, img) for pkg in (jp, tp)}
    (jd, jn), (td, tn) = out[jp], out[tp]
    # the same boxes kept, their geometry within f32 rounding of the
    # decode (sigmoid / exp in another library)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn.numpy()))
    np.testing.assert_array_equal(td.numpy()[:, 0],
                                  np.asarray(jd.numpy())[:, 0])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd.numpy()),
                               rtol=1e-5, atol=1e-5)
    # the selection itself is the JAX host kernel's: exact on one input
    b = rs.rand(2, 30, 2, 2).astype(np.float32) * 50
    b = np.sort(b, 2).reshape(2, 30, 4)[..., [0, 2, 1, 3]]
    sc = rs.rand(2, 4, 30).astype(np.float32)
    for a, c in zip(jp.ops.multiclass_nms(b, sc, 0.1, 20, 10, 0.45),
                    tp.ops.multiclass_nms(b, sc, 0.1, 20, 10, 0.45)):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a.numpy()))
    gts = [np.sort(rs.rand(3, 2, 2) * 60, axis=1).reshape(3, 4)[:, [0, 2, 1,
                                                                   3]]
           for _ in range(n)]
    labels = [rs.randint(0, 4, 3) for _ in range(n)]
    maps = {}
    for pkg, (d, num) in out.items():
        m = pkg.metric.DetectionMAP(ap_version="11point")
        dets = np.asarray(d.numpy())
        start = 0
        for i, k in enumerate(np.asarray(num.numpy())):
            m.update(dets[start:start + k], gts[i], labels[i])
            start += k
        maps[pkg] = m.accumulate()
    assert maps[tp] == maps[jp]


def test_roi_align_forward_and_backward_match_jax():
    rs = np.random.RandomState(5)
    feat = rs.randn(2, 8, 12, 16).astype(np.float32)
    rois = np.sort(rs.rand(6, 2, 2) * [256, 192], axis=1).reshape(6, 4)[
        :, [0, 2, 1, 3]].astype(np.float32)
    ct = rs.randn(6, 8, 4, 4).astype(np.float32)
    res = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(feat, stop_gradient=False)
        r = pkg.to_tensor(rois, stop_gradient=False)
        out = pkg.ops.roi_align(x, r, [3, 3], output_size=4,
                                spatial_scale=1 / 16, sampling_ratio=2)
        (out * pkg.to_tensor(ct)).sum().backward()
        res.append([np.asarray(v.numpy()) for v in (out, x.grad, r.grad)])
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
