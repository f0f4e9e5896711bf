"""Rank bodies of the distributed tier's static and high-level paths,
run through ``testing.spmd.run_ranks`` by the parity tests and by
``chip_smoke.py``: the static Executor over ``dp`` ranks with and without
recompute segments (``static_bert_dp_case``), ``Model.fit`` under a mesh
with a ``tp`` axis (``gpt_fit_case``) and ``StagedPipelineRunner`` over a
planned pipeline (``staged_mlp_case``). Each takes numpy weights and data
and returns numpy results."""
from __future__ import annotations

import torch

__all__ = ["static_bert", "encoder_checkpoints", "static_bert_dp_case",
           "GPTLM", "gpt_fit_case", "mlp_program", "staged_mlp_case",
           "suite"]


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def encoder_checkpoints(net):
    """Forward post-hooks that record each encoder layer's output
    Variable while a static BERT is recorded: the recompute checkpoints
    of one segment a layer. Returns the list they fill."""
    names = []
    for layer in net.encoder.layers:
        layer.register_forward_post_hook(
            lambda _l, _i, out: names.append(out))
    return names


def static_bert(cfg, batch, seq, opt="AdamW", lr=1e-3, amp=None,
                recompute=False, seed=0):
    """(main program, net, loss) of a static BERT MLM step:
    ``Bert(cfg)(ids, masked_lm_labels=labels)`` with AdamW (weight decay
    0.01) minimized, through ``fleet.distributed_optimizer`` when
    ``recompute`` (checkpointing each encoder layer) or ``amp`` (a level,
    with bf16 O2 masters) is asked for."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.text.models import bert
    paddle.enable_static()
    try:
        main = static.Program("bert_dp")
        with static.program_guard(main, static.Program()):
            paddle.seed(seed)
            ids = static.data("ids", [batch, seq], "int64")
            lab = static.data("labels", [batch, seq], "int64")
            net = bert.Bert(cfg)
            ck = encoder_checkpoints(net)
            loss = net(ids, masked_lm_labels=lab)
            o = getattr(paddle.optimizer, opt)(
                learning_rate=lr, parameters=net.parameters(),
                **({"weight_decay": 0.01} if opt == "AdamW" else {}))
            if recompute or amp:
                st = fleet.DistributedStrategy()
                if recompute:
                    st.recompute = True
                    st.recompute_configs = {"checkpoints": list(ck)}
                if amp:
                    st.amp = True
                    st.amp_configs = {"level": amp, "dtype": "bfloat16"}
                o = fleet.distributed_optimizer(o, st)
            o.minimize(loss)
        return main, net, loss
    finally:
        paddle.disable_static()


def static_bert_dp_case(cfg_kw, params, batches, recompute=False,
                        data_parallel=True, opt="AdamW", lr=1e-3,
                        amp=None, fetch_grads=False):
    """Steps of a static BERT (``BertConfig(**cfg_kw)``, weights
    ``params`` by module path) over ``batches`` [(ids, labels)] of the
    global batch, through ``CompiledProgram(...).with_data_parallel()``
    on a ``{"dp": world}`` mesh: {"losses", "params" (module path ->
    numpy), "grads" (module path -> the first step's gradient, when
    ``fetch_grads``),
    "allreduce_bytes", "rows"} (rows: the batch rows this rank ran)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.bridge import load_jax_static_params
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.text.models import bert
    r, n = _world()
    cfg = bert.BertConfig(**cfg_kw)
    b, s = batches[0][0].shape
    main, net, loss = static_bert(cfg, b, s, opt=opt, lr=lr, amp=amp,
                                  recompute=recompute)
    load_jax_static_params(net, params)
    mesh = M.init_mesh({"dp": n}, name="default")
    prog = static.CompiledProgram(main)
    if data_parallel:
        prog = prog.with_data_parallel(loss_name=loss.name)
    exe = static.Executor()
    grad_vars = [g for _, g in main.backward_section[1]] \
        if fetch_grads else []
    dotted = {p.scope_name: k for k, p in net.named_parameters()}
    gnames = [dotted.get(p.scope_name, p.name)
              for p, _ in main.backward_section[1]]
    out = {"losses": [], "grads": None}
    paddle.enable_static()
    try:
        for k, (x, y) in enumerate(batches):
            got = exe.run(prog, feed={"ids": x, "labels": y},
                          fetch_list=[loss] + (grad_vars if k == 0 else []))
            out["losses"].append(float(got[0]))
            if k == 0 and grad_vars:
                out["grads"] = dict(zip(gnames, got[1:]))
    finally:
        paddle.disable_static()
    scope = static.global_scope()
    out["params"] = {k: _np(scope.get(p.scope_name))
                     for k, p in net.named_parameters()}
    e = next(iter(exe._cache.values()))
    out["allreduce_bytes"] = e.dp.allreduce_bytes if e.dp else 0
    out["rows"] = b // n if e.dp else b
    M.reset_mesh("default")
    return out


def _np(t):
    t = t.detach().as_subclass(torch.Tensor).cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class GPTLM(torch.nn.Module):
    """GPT whose forward takes (ids, labels) and returns the LM loss
    through the fused CE head, for ``Model.fit`` with both as inputs."""

    def __init__(self, cfg):
        super().__init__()
        from paddle_tpu_torch.text.models import gpt
        self.gpt = gpt.GPT(cfg)

    def forward(self, ids, labels):
        return self.gpt(ids, labels=labels)


def gpt_fit_case(cfg_kw, params, X, Y, mesh_shape, steps=2, lr=1e-3,
                 opt="AdamW", rules=None, amp=None):
    """``Model.fit`` of ``GPTLM`` (``GPTConfig(**cfg_kw)``, weights
    ``params`` by module path) on (X, Y) (ids, labels) under the default
    mesh ``mesh_shape``, ``steps`` steps of the whole batch: {"losses",
    "params" (whole, gathered over tp), "state_bytes" (this rank's),
    "all_reduce_bytes" / "all_gather_bytes" (the dist.* counters over the
    fit)}. ``rules``: [(template, ndim, spec entries)] installed with
    ``sharding.add_tp_rule`` first (a plan's rules)."""
    from paddle_tpu_torch import hapi, optimizer
    from paddle_tpu_torch.bridge import load_jax_params
    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.distributed import sharding as SH
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        whole_parameters
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.text.models import gpt
    M.init_mesh(dict(mesh_shape), name="default")
    installed = []
    for tmpl, nd, spec in rules or ():
        def build(ndim, _nd=nd, _s=tuple(spec)):
            return M.PartitionSpec(*_s) if ndim == _nd \
                else M.PartitionSpec()
        SH.add_tp_rule(tmpl, build)
        installed.append(tmpl)
    try:
        net = GPTLM(gpt.GPTConfig(**cfg_kw))
        load_jax_params(net, params)
        model = hapi.Model(net, inputs=[hapi.InputSpec([None], "int64"),
                                        hapi.InputSpec([None], "int64")])
        o = getattr(optimizer, opt)(learning_rate=lr,
                                    parameters=net.parameters(),
                                    **({"multi_precision": True}
                                       if amp == "O2" else {}))
        model.prepare(o, loss=lambda loss: loss,
                      amp_configs={"level": amp, "dtype": "bfloat16"}
                      if amp else None)
        rec = {"losses": []}

        class Rec(hapi.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                rec["losses"].append(float(logs["loss"]))

        ar0 = monitor.stat_get("dist.all_reduce_bytes")
        ag0 = monitor.stat_get("dist.all_gather_bytes")
        model.fit(TensorDataset([X, Y]), batch_size=X.shape[0],
                  epochs=steps, verbose=0, shuffle=False,
                  callbacks=[Rec()])
        rec["all_reduce_bytes"] = monitor.stat_get(
            "dist.all_reduce_bytes") - ar0
        rec["all_gather_bytes"] = monitor.stat_get(
            "dist.all_gather_bytes") - ag0
        rec["state_bytes"] = model._engine.state_bytes()
        rec["params"] = {k: _np(v) for k, v in
                         whole_parameters(net).items()}
        return rec
    finally:
        for tmpl in installed:
            SH.remove_tp_rule(tmpl)
        M.reset_mesh("default")


def mlp_program(depth, batch, width, name="pp_mlp"):
    """(program, ops a layer) of a tanh MLP stack recorded by the port
    (one bias-free Linear a layer): the unit grid a staged pipeline
    executes, a plan segment a layer."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, ops, static
    paddle.enable_static()
    try:
        main = static.Program(name)
        with static.program_guard(main, static.Program()):
            h = static.data("x", [batch, width], "float32")
            for _ in range(depth):
                h = ops.tanh(nn.Linear(width, width, bias_attr=False)(h))
        main._jit_fetch_vars = [h]
        return main, len(main.ops) // depth
    finally:
        paddle.disable_static()


def staged_mlp_case(ws, x, y, pp, num_micro, num_virtual=1, steps=3,
                    lr=0.1, mesh_extra=None, cuts=None):
    """``StagedPipelineRunner`` over ``plan_pipeline`` of a tanh MLP
    (units ``tanh(h @ w)``, weights ``ws``) on a ``{"pp": pp}`` mesh
    (plus ``mesh_extra``): the plan's cuts, the losses of ``steps`` SGD
    steps, and the final unit weights gathered in plan order."""
    from paddle_tpu_torch.distributed import mesh as M
    from paddle_tpu_torch.static.pipeline_runner import StagedPipelineRunner
    from paddle_tpu_torch.static.spmd_planner import plan_pipeline
    depth, width = len(ws), ws[0].shape[0]
    main, opl = mlp_program(depth, x.shape[0], width)
    shape = {"pp": pp, **dict(mesh_extra or {})}
    plan = plan_pipeline(main, shape, num_micro=num_micro,
                         num_virtual=num_virtual,
                         boundaries=[k * opl for k in range(1, depth)],
                         cuts=None if cuts is None
                         else [c * opl for c in cuts])
    mesh = M.init_mesh(shape, name="staged")
    try:
        runner = StagedPipelineRunner(
            plan, lambda h, w: torch.tanh(h @ w), list(ws),
            lambda h, t: ((h - t) ** 2).mean(), mesh=mesh,
            learning_rate=lr)
        losses = [float(runner.step(x, y)) for _ in range(steps)]
        return {"cuts": list(plan.cuts), "losses": losses,
                "weights": [_np(w) for w in runner.unit_params()],
                "depth_peak": runner.inflight_depth_peak}
    finally:
        M.reset_mesh("staged")


def suite(cases):
    """{name: fn(*args, **kwargs)} for each name: (fn name, args, kwargs)
    of ``cases``, in one run of the ranks (the meshes reset between)."""
    from paddle_tpu_torch.distributed import mesh as M
    out = {}
    for name, (fn, args, kwargs) in cases.items():
        out[name] = globals()[fn](*args, **kwargs)
        M.reset_mesh()
    return out
