"""Port parity: the long tail's layers (SpectralNorm, TreeConv,
BilinearTensorProduct, CTCLoss, HSigmoidLoss, NCELoss), quantization/
(fake_quant's straight-through gradient, the observers, QuantedLinear /
QuantedConv2D, QAT, PTQ, weight_quantize) and the metrics ChunkEvaluator,
EditDistance and DetectionMAP, against the JAX package.

Each layer is built in JAX, its ``functional_state()`` carried into the
port's layer by ``bridge.load_jax_params`` (parameters and buffers by
path; a HistogramObserver's host histogram by
``bridge.load_jax_observer_state``), and both run on the same seeded
inputs: outputs, input and parameter gradients, and the buffers a
forward updates, at rtol 1e-5 / atol 1e-6. The metrics' counts are exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.quantization as jq
import paddle_tpu_torch as tp
import paddle_tpu_torch.quantization as tq
from paddle_tpu_torch import bridge
from paddle_tpu_torch import device as tdevice

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _carry(jlayer, tlayer):
    params, bufs = jlayer.functional_state()
    bridge.load_jax_params(tlayer, {k: np.asarray(v) for k, v in
                                    params.items()},
                           {k: np.asarray(v) for k, v in bufs.items()})
    return tlayer


def _np(x):
    return np.asarray(x.numpy())


def _forward_both(jlayer, tlayer, inputs, grad_inputs=(), ct_seed=9):
    """Outputs and gradients of sum(out * ct) of both layers."""
    res = {}
    for pkg, layer in ((jp, jlayer), (tp, tlayer)):
        args = [pkg.to_tensor(a, stop_gradient=i not in grad_inputs)
                if isinstance(a, np.ndarray) else a
                for i, a in enumerate(inputs)]
        out = layer(*args)
        ct = np.random.RandomState(ct_seed).uniform(
            -1, 1, tuple(out.shape)).astype(np.float32)
        (out * pkg.to_tensor(ct)).sum().backward()
        res[pkg] = (_np(out), [_np(args[i].grad) for i in grad_inputs],
                    {n: _np(p.grad) for n, p in layer.named_parameters()
                     if p.grad is not None})
    (jo, jg, jpg), (to, tg, tpg) = res[jp], res[tp]
    np.testing.assert_allclose(to, jo, **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL)
    assert set(tpg) == set(jpg)
    for k in jpg:
        np.testing.assert_allclose(tpg[k], jpg[k], err_msg=k, **TOL)


def _seeded(build):
    jp.seed(3)
    tp.seed(3)
    return build(jp), build(tp)


def test_spectral_norm_layer_carries_u_v_and_matches_jax():
    """Forward and the buffers' power iteration against the JAX layer; the
    gradient against ``jax.grad`` of the same W / (u^T W v) (the JAX
    layer's eager output has no tape node: a reference quirk)."""
    import jax
    import jax.numpy as jnp
    jl, tl = _seeded(lambda p: p.nn.SpectralNorm([4, 3, 2], dim=1,
                                                 power_iters=2))
    _carry(jl, tl)
    w = np.random.RandomState(1).randn(4, 3, 2).astype(np.float32)
    ct = np.random.RandomState(2).randn(4, 3, 2).astype(np.float32)
    jo = _np(jl(jp.to_tensor(w)))
    wt = tp.to_tensor(w, stop_gradient=False)
    to = tl(wt)
    (to * tp.to_tensor(ct)).sum().backward()
    np.testing.assert_allclose(_np(to), jo, **TOL)
    u, v = _np(jl.weight_u), _np(jl.weight_v)
    np.testing.assert_allclose(_np(tl.weight_u), u, **TOL)
    np.testing.assert_allclose(_np(tl.weight_v), v, **TOL)

    def f(wv):
        mat = jnp.transpose(wv, (1, 0, 2)).reshape(3, -1)
        return jnp.sum(ct * wv / (u @ (mat @ v)))
    np.testing.assert_allclose(_np(wt.grad), np.asarray(jax.grad(f)(w)),
                               **TOL)


def test_tree_conv_and_bilinear_tensor_product_layers_match_jax():
    jl, tl = _seeded(lambda p: p.nn.TreeConv(3, 2, num_filters=2))
    _carry(jl, tl)
    nodes = np.random.RandomState(2).randn(2, 5, 3).astype(np.float32)
    edges = np.array([[[1, 2], [1, 3], [1, 4], [2, 5], [0, 0]],
                      [[1, 2], [2, 3], [2, 4], [0, 0], [0, 0]]], np.int64)
    _forward_both(jl, tl, [nodes, edges], grad_inputs=(0,))
    jl, tl = _seeded(lambda p: p.nn.BilinearTensorProduct(4, 5, 3))
    _carry(jl, tl)
    rs = np.random.RandomState(3)
    _forward_both(jl, tl, [rs.randn(2, 4).astype(np.float32),
                           rs.randn(2, 5).astype(np.float32)],
                  grad_inputs=(0, 1))


def test_loss_layers_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(4, 3).astype(np.float32)
    jl, tl = _seeded(lambda p: p.nn.HSigmoidLoss(3, 6))
    _carry(jl, tl)
    _forward_both(jl, tl, [x, rs.randint(0, 6, 4).astype(np.int64)],
                  grad_inputs=(0,))
    logits = rs.randn(6, 2, 4).astype(np.float32)
    lab = rs.randint(1, 4, (2, 3)).astype(np.int64)
    il, ll = np.array([6, 5]), np.array([3, 2])
    out = [pkg.nn.CTCLoss(blank=0, reduction="sum")(
        *[pkg.to_tensor(a) for a in (logits, lab, il, ll)],
        norm_by_times=True) for pkg in (jp, tp)]
    np.testing.assert_allclose(_np(out[1]), _np(out[0]), rtol=1e-5)


def test_nce_layer_matches_jax_on_given_samples():
    rs = np.random.RandomState(5)
    x = rs.randn(4, 3).astype(np.float32)
    label = rs.randint(0, 10, (4, 1)).astype(np.int64)
    sample = rs.randint(0, 10, 4).astype(np.int64)
    jl, tl = _seeded(lambda p: p.nn.NCELoss(10, 3, num_neg_samples=4))
    _carry(jl, tl)
    grads = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        out = layer(xt, pkg.to_tensor(label),
                    sample_ids=pkg.to_tensor(sample))
        out.sum().backward()
        grads.append((_np(out), _np(xt.grad), _np(layer.weight.grad)))
    for a, b in zip(grads[1], grads[0]):
        np.testing.assert_allclose(a, b, **TOL)


def _mlp(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(6, 8), pkg.nn.ReLU(),
                             pkg.nn.Linear(8, 3))


@pytest.mark.parametrize("observer", ["absmax", "histogram"])
def test_qat_step_matches_jax(observer):
    """QAT over two Linear layers: the forward (weights per channel,
    activations by the observer), the straight-through gradients and the
    observers' scales after the step, JAX's."""
    jm, tm = _seeded(_mlp)
    bridge.load_jax_params(tm, {k: np.asarray(v._value)
                                for k, v in jm.named_parameters()})
    cfg = dict(act_observer=observer)
    jm = jq.QAT(jq.QuantConfig(**cfg)).quantize(jm)
    tm = tq.QAT(tq.QuantConfig(**cfg)).quantize(tm)
    assert type(tm[0]).__name__ == "QuantedLinear"
    rs = np.random.RandomState(6)
    for step in range(2):
        x = (rs.randn(5, 6) * (1 + step)).astype(np.float32)
        _forward_both(jm, tm, [x], grad_inputs=(0,), ct_seed=step)
        for (n, a), (_, b) in zip(jm.named_buffers(), tm.named_buffers()):
            np.testing.assert_allclose(_np(b), np.asarray(a._value),
                                       err_msg=n, **TOL)
        for m in (jm, tm):
            for p in m.parameters():
                p.clear_gradient() if hasattr(p, "clear_gradient") \
                    else setattr(p, "grad", None)


def test_ptq_calibration_and_weight_quantize_match_jax():
    jm, tm = _seeded(_mlp)
    bridge.load_jax_params(tm, {k: np.asarray(v._value)
                                for k, v in jm.named_parameters()})
    cfg = dict(act_observer="histogram")
    jq_, tq_ = jq.PTQ(jq.QuantConfig(**cfg)), tq.PTQ(tq.QuantConfig(**cfg))
    jm, tm = jq_.quantize(jm, inplace=False), tq_.quantize(tm, inplace=False)
    rs = np.random.RandomState(7)
    batches = [(rs.randn(8, 6) * s).astype(np.float32) for s in (1, 3, 2)]
    jq_.calibrate(jm, batches)
    tq_.calibrate(tm, batches)
    for (n, a), (_, b) in zip(jm.named_buffers(), tm.named_buffers()):
        np.testing.assert_allclose(_np(b), np.asarray(a._value), err_msg=n,
                                   rtol=1e-6)
    jq_.convert(jm)
    tq_.convert(tm)
    x = rs.randn(4, 6).astype(np.float32)
    np.testing.assert_allclose(_np(tm(tp.to_tensor(x))),
                               _np(jm(jp.to_tensor(x))), **TOL)
    jw, tw = jq.weight_quantize(jm), tq.weight_quantize(tm)
    assert set(jw) == set(tw) == {"0", "2"}
    for k in jw:
        np.testing.assert_array_equal(tw[k]["int8"], jw[k]["int8"])
        np.testing.assert_allclose(tw[k]["scale"], jw[k]["scale"], **TOL)


def test_histogram_state_carries_across_the_bridge():
    """A JAX histogram observer's host state, carried, gives the port the
    same scale after one more batch."""
    jo, to = jq.HistogramObserver(bins=64), tq.HistogramObserver(bins=64)
    rs = np.random.RandomState(8)
    jo(jp.to_tensor(rs.randn(50).astype(np.float32)))
    bridge.load_jax_observer_state(
        torch.nn.ModuleDict({"obs": to}), {"obs": (jo._hist, jo._hi)})
    to.scale.fill_(float(np.asarray(jo.scale._value)))
    nxt = (rs.randn(50) * 4).astype(np.float32)
    jo(jp.to_tensor(nxt))
    to(tp.to_tensor(nxt))
    np.testing.assert_allclose(_np(to.scale), np.asarray(jo.scale._value),
                               rtol=1e-6)
    with pytest.raises(KeyError):
        bridge.load_jax_observer_state(torch.nn.ModuleDict({"x": to}),
                                       {"y": (jo._hist, jo._hi)})


def test_quanted_conv2d_matches_jax():
    jc, tc = _seeded(lambda p: p.nn.Sequential(p.nn.Conv2D(2, 3, 3,
                                                           padding=1)))
    bridge.load_jax_params(tc, {k: np.asarray(v._value)
                                for k, v in jc.named_parameters()})
    jc = jq.QAT().quantize(jc)
    tc = tq.QAT().quantize(tc)
    x = np.random.RandomState(9).randn(2, 2, 5, 5).astype(np.float32)
    _forward_both(jc, tc, [x], grad_inputs=(0,))


def test_fake_quant_straight_through_gradient():
    x = tp.to_tensor(np.array([-2.0, -0.5, 0.1, 0.7, 1.5], np.float32),
                     stop_gradient=False)
    y = tq.fake_quant(x, 1.0, bits=8)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0, 1, 1, 1, 0])
    np.testing.assert_allclose(y.numpy(), np.clip(np.round(
        np.clip(x.detach().numpy(), -1, 1) * 127) / 127, -1, 1), rtol=1e-6)


def test_chunk_evaluator_and_edit_distance_match_jax():
    rs = np.random.RandomState(10)
    for pkg_pair in [(jp.metric.ChunkEvaluator(num_chunk_types=3),
                      tp.metric.ChunkEvaluator(num_chunk_types=3))]:
        jm, tm = pkg_pair
        for _ in range(3):
            inf = rs.randint(0, 7, (4, 12))
            lab = rs.randint(0, 7, (4, 12))
            lens = rs.randint(5, 13, 4)
            jm.update(inf, lab, lens)
            tm.update(tp.to_tensor(inf), tp.to_tensor(lab), lens)
        assert (tm.num_infer, tm.num_label, tm.num_correct) == \
            (jm.num_infer, jm.num_label, jm.num_correct)
        assert tm.accumulate() == jm.accumulate()
    je, te = jp.metric.EditDistance(), tp.metric.EditDistance()
    for _ in range(2):
        h, r = rs.randint(0, 5, (3, 7)), rs.randint(0, 5, (3, 6))
        je.update(jp.to_tensor(h), jp.to_tensor(r))
        te.update(tp.to_tensor(h), tp.to_tensor(r))
    assert te.count == je.count == 6
    np.testing.assert_allclose(te.accumulate(), je.accumulate(), rtol=1e-12)


@pytest.mark.parametrize("ap_version", ["11point", "integral"])
def test_detection_map_matches_jax(ap_version):
    rs = np.random.RandomState(11)
    jm = jp.metric.DetectionMAP(ap_version=ap_version)
    tm = tp.metric.DetectionMAP(ap_version=ap_version)
    for _ in range(4):
        g = rs.randint(1, 5)
        gt = np.sort(rs.rand(g, 2, 2), axis=1).reshape(g, 4)[:, [0, 2, 1, 3]]
        gl = rs.randint(0, 3, g)
        det = np.concatenate([rs.randint(0, 3, (6, 1)), rs.rand(6, 1),
                              np.clip(np.repeat(gt, 2, 0)[:6]
                                      + rs.randn(min(6, 2 * g), 4)[:6]
                                      * 0.05, 0, 1)
                              if 2 * g >= 6 else
                              np.sort(rs.rand(6, 2, 2), 1).reshape(6, 4)],
                             1).astype(np.float32)
        dif = rs.rand(g) > 0.8
        jm.update(det, gt, gl, dif)
        tm.update(tp.to_tensor(det), tp.to_tensor(gt), tp.to_tensor(gl),
                  dif)
    assert tm.accumulate() == jm.accumulate()
