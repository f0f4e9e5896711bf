"""Rank bodies for the training half of the distributed tier: the ring
and Ulysses gradients, the pipeline schedules, MoE, synchronized batch
norm, LocalSGD and the fleet ``Model.fit`` paths. Each runs on every rank
of ``testing.spmd.run_ranks`` with the global numpy inputs and returns
this rank's results (numpy in the parent)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ring_grad_case", "pipeline_case", "moe_case", "sync_bn_case",
           "localsgd_case", "fit_case", "moe_bn_suite", "fleet_suite"]


def _dev():
    from ..device import resolve_device
    return resolve_device()


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(
        _dev(), dtype)
    return t.requires_grad_() if grad else t


def _world():
    from ..distributed import mesh as M
    return M.world_rank(), M.world_size()


def ring_grad_case(q, k, v, ct, dtype="float32"):
    """Ring and Ulysses attention (causal and not) over an sp mesh of the
    world through ``sequence_parallel_attention`` on inputs that need a
    gradient, the loss sum(out * ct): the global output and dq, dk, dv on
    every rank."""
    from ..distributed import mesh as M
    from ..distributed import ring_attention as R
    mesh = M.init_mesh({"sp": M.world_size()}, name="sp_grad")
    dt = getattr(torch, dtype)
    out = {}
    for mode in ("ring", "ulysses"):
        for causal in (False, True):
            ts = [_t(a, dt, grad=True) for a in (q, k, v)]
            o = R.sequence_parallel_attention(*ts, mesh=mesh, causal=causal,
                                              mode=mode)
            (o.float() * _t(ct)).sum().backward()
            out[f"{mode}_causal{int(causal)}"] = {
                "o": o.detach(), "dq": ts[0].grad, "dk": ts[1].grad,
                "dv": ts[2].grad}
    M.reset_mesh("sp_grad")
    return out


def pipeline_case(ws, x, y, ws_v, n_micro=(2, 4)):
    """Over a pp mesh of the world (rank r holds stage tanh(h @ ws[r])):
    gpipe's finished outputs; the pipeline loss and the gradients of the
    stage weight and of the input for "gpipe" and "1f1b" at each
    micro-batch count, and "interleaved" with rank r's chunks c the
    weights ws_v[c * n + r]."""
    from ..distributed import mesh as M
    from ..distributed import pipeline as PL
    r, n = _world()
    mesh = M.init_mesh({"pp": n}, name="pp")
    res = {}

    def mb_loss(h, lbl):
        return ((h - lbl) ** 2).mean()

    with M.MeshGuard(mesh):
        w = _t(ws[r])
        outs = PL.gpipe(lambda h: torch.tanh(h @ w),
                        PL.micro_batch(_t(x), 4), "pp")
        res["gpipe_outs"] = outs
        for sched in ("gpipe", "1f1b"):
            for m in n_micro:
                w = _t(ws[r], grad=True)
                xt = _t(x, grad=True)
                loss = PL.pipeline_loss(
                    lambda h: torch.tanh(h @ w), mb_loss,
                    PL.micro_batch(xt, m), PL.micro_batch(_t(y), m), "pp",
                    schedule=sched)
                loss.backward()
                res[f"{sched}_m{m}"] = {"loss": loss.detach(), "dw": w.grad,
                                        "dx": xt.grad}
        v = ws_v.shape[0] // n
        wv = [_t(ws_v[c * n + r], grad=True) for c in range(v)]
        xt = _t(x, grad=True)
        chunks = [lambda h, c=c: torch.tanh(h @ wv[c]) for c in range(v)]
        loss = PL.pipeline_loss(chunks, mb_loss, PL.micro_batch(xt, n),
                                PL.micro_batch(_t(y), n), "pp",
                                schedule="interleaved")
        loss.backward()
        res["interleaved"] = {"loss": loss.detach(),
                              "dw": torch.stack([t.grad for t in wv]),
                              "dx": xt.grad}
    res["pipeline_layer"] = _pipeline_layer(ws_v, x, y, mesh)
    M.reset_mesh("pp")
    return res


def _pipeline_layer(ws_v, x, y, mesh):
    """A PipelineLayer of len(ws_v) bias-free Linear layers (weights
    ws_v) with the MSE loss, "1f1b" over 4 micro-batches, then the same
    with two virtual stages a rank: the loss and this rank's stages'
    weight gradients."""
    from .. import nn
    from ..distributed import mesh as M
    from ..distributed.fleet.meta_parallel import LayerDesc, PipelineLayer
    out = {}
    for v in (1, 2):
        with M.MeshGuard(mesh):
            pipe = PipelineLayer(
                [LayerDesc(nn.Linear, x.shape[1], x.shape[1],
                           bias_attr=False) for _ in range(len(ws_v))],
                loss_fn=lambda h, lbl: ((h - lbl) ** 2).mean(),
                num_micro=4, schedule="1f1b",
                num_virtual_pipeline_stages=v)
            with torch.no_grad():
                for i, lin in enumerate(l for st in pipe.stages for l in st):
                    lin.weight.copy_(_t(ws_v[i]))
            loss = pipe.pipeline_loss(_t(x), _t(y))
            loss.backward()
        out[f"v{v}"] = {"loss": loss.detach(), "grads": torch.stack([
            lin.weight.grad if lin.weight.grad is not None
            else torch.zeros_like(lin.weight)
            for st in pipe.stages for lin in st])}
    return out


def moe_case(params, x, ct, capacity_factor=1.25):
    """MoELayer over an ep mesh of the world: the JAX layer's ``params``
    (whole expert stacks) through the bridge, this rank's tokens x[r]
    ([b, s, d] a rank), the loss sum(out * ct[r]); the output, the expert
    and gate gradients and the dropped-token count. Then the dense
    fallback over the same tokens, outside a region."""
    from ..bridge import load_jax_params
    from ..core import monitor
    from ..distributed import mesh as M
    from ..distributed.moe import MoELayer
    r, n = _world()
    e = params["w_up"].shape[0]
    d_model, d_hidden = params["w_up"].shape[1:]
    mesh = M.init_mesh({"ep": n}, name="ep")
    M.set_mesh(mesh, "ep")
    with M.MeshGuard(mesh):
        moe = MoELayer(d_model, d_hidden, e, capacity_factor=capacity_factor,
                       axis="ep")
    load_jax_params(moe, params)
    dropped0 = monitor.stat_get("moe.dropped_tokens")
    xt = _t(x[r], grad=True)
    out = M.shard_map(moe, mesh=mesh, in_specs=(M.P(),),
                      out_specs=M.P())(xt)
    (out * _t(ct[r])).sum().backward()
    res = {"out": out.detach(), "dx": xt.grad,
           "dropped": monitor.stat_get("moe.dropped_tokens") - dropped0}
    res.update({k: getattr(moe, k).grad for k in
                ("w_up", "b_up", "w_down", "b_down")})
    res["gate"] = moe.gate.weight.grad
    M.reset_mesh("ep")
    M.reset_mesh()
    dense = MoELayer(d_model, d_hidden, e, capacity_factor=capacity_factor,
                     axis="ep")
    load_jax_params(dense, params)
    xd = _t(x[r], grad=True)
    od = dense(xd)
    (od * _t(ct[r])).sum().backward()
    res["dense"] = {"out": od.detach(), "dx": xd.grad,
                    "w_up": dense.w_up.grad, "gate": dense.gate.weight.grad}
    return res


def sync_bn_case(x, ct, weight, bias):
    """SyncBatchNorm over a dp mesh of the world under shard_map (the
    batch sharded, the output gathered), one training forward and the
    loss sum(out * ct): the output, dx, this rank's share of dweight and
    dbias, the running stats."""
    from .. import nn
    from ..distributed import mesh as M
    r, n = _world()
    mesh = M.init_mesh({"dp": n}, name="bn")
    bn = nn.SyncBatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(_t(weight))
        bn.bias.copy_(_t(bias))
    bn.train()
    xt = _t(x, grad=True)
    out = M.shard_map(bn, mesh=mesh, in_specs=(M.P("dp"),),
                      out_specs=M.P("dp"))(xt)
    (out * _t(ct)).sum().backward()
    res = {"out": out.detach(), "dx": xt.grad, "dw": bn.weight.grad,
           "db": bn.bias.grad, "mean": bn._mean.detach().clone(),
           "var": bn._variance.detach().clone()}
    M.reset_mesh("bn")
    return res


def localsgd_case(w0, x, y, lr=0.1, k=2, steps=5):
    """``LocalSGD`` of a linear least-squares model over a dp mesh of the
    world: each rank's replica steps SGD on its shard of (x, y) (the
    global batch on every rank), parameters averaged every ``k`` steps.
    Returns the losses, this rank's replica after each step and the
    average at the end."""
    from ..distributed import mesh as M
    from ..distributed.localsgd import LocalSGD
    r, n = _world()
    mesh = M.init_mesh({"dp": n}, name="lsgd")

    def step_fn(params, batch):
        w = params["w"].detach().requires_grad_()
        xb, yb = batch[:, :x.shape[1]], batch[:, x.shape[1]:]
        loss = ((xb @ w - yb) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        return loss.detach(), {"w": (w - lr * g).detach()}

    tr = LocalSGD(step_fn, {"w": _t(w0)}, k_steps=k, mesh=mesh)
    batch = _t(np.concatenate([x, y], 1))
    losses, replicas = [], []
    for _ in range(steps):
        losses.append(tr.step(batch))
        replicas.append(tr.params["w"].clone())
    res = {"losses": np.asarray(losses), "replicas": torch.stack(replicas),
           "averaged": tr.averaged_params()["w"]}
    M.reset_mesh("lsgd")
    return res


def fit_case(kind, X, Y, init=None, lr=0.05, save_to=None, epochs=2,
             batch=16, k_steps=2, wrap=False, drop_last=True):
    """``Model.fit`` under ``fleet.init`` over a dp mesh of the world:
    kind "dp" (Linear + Adam through ``distributed_optimizer``), "zero"
    (the same with ``strategy.sharding``), "convnet" (BASELINE config 4:
    Conv2D / ReLU / pool / Linear, Momentum, cross entropy) or
    "localsgd" (Linear + SGD, ``strategy.localsgd`` k ``k_steps``, then
    ``train_batch`` steps on the whole of X, Y and ``Model.save(save_to)``)
    or "adaptive" (``adaptive_localsgd`` from k 1, four ``train_batch``
    steps: k after them). ``wrap``: the Model's network is
    ``fleet.distributed_model(net)``. ``init``: the JAX
    network's parameters to start from (through the bridge). Returns the
    History losses (LocalSGD: each step's loss and this rank's replica),
    the parameters, the slots and the optimizer-state bytes of this
    rank."""
    from .. import Model, nn, optimizer
    from ..distributed import fleet
    from ..distributed import mesh as M
    from ..hapi.callbacks import History
    from ..io import TensorDataset
    import paddle_tpu_torch as paddle
    paddle.seed(6)
    torch.manual_seed(6)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": M.world_size()}
    if kind == "zero":
        strategy.sharding = True
    if kind == "localsgd":
        strategy.localsgd = True
        strategy.localsgd_configs = {"k_steps": k_steps}
    if kind == "adaptive":
        strategy.adaptive_localsgd = True
        strategy.localsgd_configs = {"k_steps": 1}
    fleet.init(is_collective=True, strategy=strategy)
    if kind == "convnet":
        net = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.ReLU(),
                            nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                            nn.Linear(8, 4))
        opt = optimizer.Momentum(learning_rate=lr,
                                 parameters=net.parameters())
        loss = nn.CrossEntropyLoss()
        Yt = np.asarray(Y, np.int64)
    else:
        net = nn.Linear(X.shape[1], Y.shape[1])
        opt = (optimizer.SGD if kind in ("localsgd", "adaptive")
               else optimizer.Adam)(
            learning_rate=lr, parameters=net.parameters())
        loss = nn.MSELoss()
        Yt = np.asarray(Y, np.float32)
    if init is not None:
        from ..bridge import load_jax_params
        load_jax_params(net, init)
    return _fit_run(kind, net, opt, loss, X, Yt, strategy, epochs, batch,
                    save_to, Model, History, TensorDataset, fleet, wrap,
                    drop_last)


def _fit_run(kind, net, opt, loss, X, Yt, strategy, epochs, batch, save_to,
             Model, History, TensorDataset, fleet, wrap=False,
             drop_last=True):
    init = {n: p.detach().clone() for n, p in net.named_parameters()}
    dopt = fleet.distributed_optimizer(opt, strategy)
    model = Model(fleet.distributed_model(net) if wrap else net)
    model.prepare(optimizer=dopt, loss=loss)
    res = {"init": init}
    if kind == "adaptive":
        for _ in range(4):
            model.train_batch([X], [Yt])
        res["k"] = model._engine._localsgd["k"]
        return res
    if kind == "localsgd":
        from ..distributed import mesh as M
        steps = []
        for _ in range(3):
            lv = model.train_batch([X], [Yt])[0]
            steps.append({"loss": lv,
                          "w": net.weight.detach().clone()})
        res["steps"] = steps
        # save averages the replicas first; rank 0 writes
        model.save(save_to)
        res["params"] = {n: p.detach().clone()
                         for n, p in net.named_parameters()}
        res["rank"] = M.world_rank()
        if res["rank"] == 0:
            from ..framework.io import load
            res["saved"] = {k: np.asarray(v) for k, v in
                            load(save_to + ".pdparams").items()}
        return res
    h = History()
    model.fit(TensorDataset([X, Yt]), batch_size=batch, epochs=epochs,
              verbose=0, shuffle=False, callbacks=[h], drop_last=drop_last)
    res["losses"] = np.asarray(h.history["loss"], np.float64)
    res["state_bytes"] = model._engine.zero_state_bytes()
    res["params"] = {n: p.detach().clone() for n, p in net.named_parameters()}
    model._engine.consolidate_zero()
    res["slots"] = {f"{n}/{s}": v.clone() for n, sl in opt._slots.items()
                    for s, v in sl.items()}
    return res


def moe_bn_suite(moe, bn):
    """``moe_case(*moe)`` and ``sync_bn_case(*bn)`` in one run of the
    ranks."""
    return {"moe": moe_case(*moe), "sync_bn": sync_bn_case(*bn)}


def fleet_suite(lsgd, fit):
    """``localsgd_case(*lsgd)`` and ``fit_case(**kwargs)`` for each
    {name: kwargs} of ``fit`` in one run of the ranks."""
    from ..distributed import mesh as M
    out = {"localsgd": localsgd_case(*lsgd)}
    for name, kwargs in fit.items():
        out[f"fit_{name}"] = fit_case(**kwargs)
        M.reset_mesh()
    out["fleet_init"] = fleet_init_case()
    return out


def fleet_init_case():
    """``fleet.init`` with dp 2 x mp 2 over a world of 4: the mesh, the
    HybridCommunicateGroup's sizes and this rank's coordinates, and
    ``UtilBase``'s reductions of this rank's values."""
    from ..distributed import fleet
    from ..distributed import mesh as M
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    m = M.get_mesh()
    r = M.world_rank()
    util = fleet.util.UtilBase()
    out = {"axes": list(m.axis_names), "shape": dict(m.shape),
           "sizes": [hcg.get_data_parallel_world_size(),
                     hcg.get_model_parallel_world_size(),
                     hcg.get_pipe_parallel_world_size()],
           "ranks": [hcg.get_data_parallel_rank(),
                     hcg.get_model_parallel_rank(), hcg.get_stage_id()],
           "worker": [fleet.worker_index(), fleet.worker_num(),
                      fleet.is_first_worker()],
           "util_sum": util.all_reduce(np.asarray([r, 1.0]), "sum"),
           "util_max": util.all_reduce(np.asarray([r, -r]), "max"),
           "util_gather": util.all_gather({"rank": r})}
    fleet.barrier_worker()
    M.reset_mesh()
    return out
