"""Multi-rank runs on one host: ``run_ranks(fn, n, *args, tmp_path=...)``
starts ``n`` processes through ``distributed.spawn``, each joining the
process group through the public PADDLE_* path
(``bootstrap.maybe_initialize_distributed``: ``gloo`` on the CPU and
where the ranks share a card) over a ``FileStore`` in ``tmp_path`` (no
TCP port, so concurrent runs cannot collide), runs ``fn(*args)`` on its
rank, and returns the ranks' results (numpy: tensors are converted in the
child).

``fn`` is a module-level function, pickled by reference: its module must
be importable in the children (this package, or the script the parent
runs). The bodies below are the collective tier's parity cases.
"""
from __future__ import annotations

import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["run_ranks", "to_numpy", "collectives_battery",
           "attention_case", "tp_case", "dp_case", "parity_suite"]


def to_numpy(tree):
    """Tensors (any depth of dict / list / tuple) as numpy arrays; bf16 as
    f32."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().as_subclass(torch.Tensor).cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def run_ranks(fn, n, *args, tmp_path, device="cpu", timeout=300.0):
    """[result of rank r for r in range(n)] of ``fn(*args)`` run on ``n``
    ranks. A failing or hung rank kills the others and raises with its
    output's tail. ``device``: the ranks' current device ("cpu" or
    "cuda")."""
    from ..distributed.spawn import spawn
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    base = tmp / f"ranks-{os.getpid()}-{time.monotonic_ns()}"
    job = {"fn": fn, "args": args, "device": device, "out": str(base),
           "threads": max(1, (os.cpu_count() or 4) // (2 * n))}
    procs = spawn(_rank_main, args=(job,), nprocs=n, join=False,
                  daemon=True, init_method=f"file://{base}.store")
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = "timeout"
                break
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
    if failed is not None:
        r = 0 if failed == "timeout" else failed
        log = Path(f"{base}.{r}.log")
        tail = log.read_text(errors="replace")[-4000:] if log.exists() \
            else ""
        raise RuntimeError(
            f"run_ranks({fn.__module__}.{fn.__qualname__}, {n}): rank "
            f"{failed} failed (exit code {procs[r].exitcode}):\n{tail}")
    results = []
    for r in range(n):
        with open(f"{base}.{r}", "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(job):
    """A spawned rank: its output to ``<out>.<rank>.log``, then the group
    through the PADDLE_* env, ``fn``, and the result to ``<out>.<rank>``."""
    import torch.distributed as dist

    from ..device import device_scope
    from ..distributed.bootstrap import maybe_initialize_distributed
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    fd = os.open(f"{job['out']}.{rank}.log",
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    torch.set_num_threads(int(job["threads"]))
    maybe_initialize_distributed()
    try:
        with device_scope(job["device"]):
            out = to_numpy(job["fn"](*job["args"]))
        with open(f"{job['out']}.{rank}", "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def _dev():
    from ..device import resolve_device
    return resolve_device()


def collectives_battery(k=8):
    """Every collective on integer-valued f32 tensors of this rank:
    the five reduce ops over dp (PROD over values with zeros and signs), a
    3-of-4 subgroup, all_gather, reduce, reduce_scatter (four ops, and
    the all-reduce path of a backend without it), alltoall,
    broadcast, scatter, a ppermute ring, send / recv in pairs, and
    hierarchical_all_reduce on a 2 x 2 mesh (pod "dcn" x dp "ici") and a
    shard_map output gathered over (dp, pod), against the mesh's order.
    Returns {case: this rank's result}."""
    from ..distributed import collective as C
    from ..distributed import mesh as M
    r, n = M.world_rank(), M.world_size()
    dev = _dev()
    mesh = M.init_mesh({"dp": n})
    x = torch.arange(k, dtype=torch.float32, device=dev) + 3 * r
    signed = torch.tensor([r - 1.0, 2.0, -1.0, 0.0 if r == 2 else 1.5],
                          device=dev)
    out = {}
    with M.MeshGuard(mesh):
        for op in ("sum", "max", "min", "avg"):
            out[f"all_reduce_{op}"] = C._allreduce_raw(x, axis="dp", op=op)
        out["all_reduce_prod"] = C._allreduce_raw(signed, axis="dp",
                                                  op="prod")
        sub = C.Group("dp", ranks=[0, 1, 2])
        for op in ("sum", "max", "prod"):
            t = (signed if op == "prod" else x).clone()
            out[f"subgroup_{op}"] = C.all_reduce(t, op=op, group=sub)
        lst = []
        C.all_gather(lst, x)
        out["all_gather"] = torch.stack(lst)
        out["reduce"] = C.reduce(x.clone(), dst=1)
        rs = torch.arange(4 * n, dtype=torch.float32, device=dev) * (r + 1)
        for op in ("sum", "max", "avg"):
            key = "reduce_scatter" + ("" if op == "sum" else f"_{op}")
            out[key] = C._reduce_scatter_raw(rs, axis="dp", op=op)
        out["reduce_scatter_prod"] = C._reduce_scatter_raw(
            signed, axis="dp", op="prod")
        # the path for a backend without reduce-scatter: an all-reduce,
        # then the chunk
        table = C._transport[rs.device.type]
        mode = table["reduce_scatter"]
        table["reduce_scatter"] = "all_reduce"
        try:
            out["reduce_scatter_via_all_reduce"] = C._reduce_scatter_raw(
                rs, axis="dp", op="sum")
        finally:
            table["reduce_scatter"] = mode
        out["alltoall"] = C._alltoall_raw(
            torch.arange(n * 3, dtype=torch.float32, device=dev)
            .reshape(n, 3) + 100 * r, axis="dp")
        out["broadcast"] = C._broadcast_raw(x, axis="dp", src=3)
        out["broadcast_sub"] = C._broadcast_raw(x, axis="dp", src=2,
                                                members=(1, 2, 3))
        out["scatter"] = C._scatter_raw(
            torch.arange(n * 2, dtype=torch.float32, device=dev)
            .reshape(n, 2) + 10 * r, axis="dp", src=1)
        out["ppermute"] = C._ppermute_raw(
            x, axis="dp", perm=tuple((i, (i + 1) % n) for i in range(n)))
        buf = torch.zeros(k, device=dev)
        if r % 2 == 0:
            C.send(x, dst=r + 1)
        else:
            C.recv(buf, src=r - 1)
        out["send_recv"] = buf
    hmesh = M.init_mesh({"pod": {"size": 2, "tier": "dcn"}, "dp": n // 2},
                        name="hier")
    with M.MeshGuard(hmesh):
        out["hierarchical_sum"] = C.hierarchical_all_reduce(
            x.clone(), op="sum", inner_axis="dp", outer_axis="pod")
        out["hierarchical_avg"] = C.hierarchical_all_reduce(
            x[:5].clone(), op="avg", inner_axis="dp", outer_axis="pod")
        out["hierarchical_max"] = C.hierarchical_all_reduce(
            x.clone(), op="max", inner_axis="dp", outer_axis="pod")
    # a gather over two axes in the other order than the mesh's: the
    # line's positions are dp * 2 + pod
    out["gather_dp_pod"] = M.shard_map(
        lambda v: v[None], mesh=hmesh, in_specs=(M.P(),),
        out_specs=M.P(("dp", "pod")))(x)
    out["tiers"] = M.axis_tiers(hmesh)
    out["transport"] = C.transport_table()
    out["transport_cpu"] = C.transport_table("cpu")
    M.reset_mesh()
    return out


def attention_case(q, k, v, scale=None, dtype="float32"):
    """Ring (causal and not) and Ulysses attention of global numpy
    [b, h, s, d] inputs over an sp mesh of the world, on every rank's
    current device; returns the global outputs and the ring's step and
    skip counts, with the flash launches of this rank."""
    from ..distributed import mesh as M
    from ..distributed import ring_attention as R
    from ..ops import cuda as kernels
    dev = _dev()
    dt = getattr(torch, dtype)
    mesh = M.init_mesh({"sp": M.world_size()})
    t = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
         for a in (q, k, v)]
    out = {}
    for causal in (False, True):
        R.reset_ring_stats()
        kernels.reset_launch_counts()
        out[f"ring_causal{int(causal)}"] = R.sequence_parallel_attention(
            *t, mesh=mesh, causal=causal, scale=scale, mode="ring")
        out[f"ring_causal{int(causal)}_stats"] = R.ring_stats()
        out[f"ring_causal{int(causal)}_launches"] = kernels.launch_counts()
    for causal in (False, True):
        out[f"ulysses_causal{int(causal)}"] = R.sequence_parallel_attention(
            *t, mesh=mesh, causal=causal, scale=scale, mode="ulysses")
    M.reset_mesh()
    return out


def tp_case(x, wc, bc, wr, br, ct, emb_w, ids, emb_ct):
    """GPT-style MLP as ColumnParallelLinear (no gather) + GELU +
    RowParallelLinear over a tp mesh of the world, each rank holding its
    shards of the dense weights ``wc`` [in, hid], ``bc``, ``wr`` [hid,
    out], ``br``; forward and backward against cotangent ``ct`` under
    shard_map (x and the output replicated). Then VocabParallelEmbedding
    of ``emb_w`` [V, d] at ``ids``. Returns the outputs, x's gradient
    and this rank's weight-shard gradients."""
    from .. import nn
    from ..distributed import mesh as M
    from ..distributed.fleet import meta_parallel as MP
    dev = _dev()
    tp = M.world_size()
    mesh = M.init_mesh({"tp": tp})
    r = M.world_rank()
    hid = wc.shape[1]
    col = MP.ColumnParallelLinear(wc.shape[0], hid, gather_output=False)
    row = MP.RowParallelLinear(hid, wr.shape[1], input_is_parallel=True)
    sl = slice(r * hid // tp, (r + 1) * hid // tp)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    with torch.no_grad():
        col.inner.weight.copy_(T(wc[:, sl]))
        col.inner.bias.copy_(T(bc[sl]))
        row.inner.weight.copy_(T(wr[sl, :]))
        row.bias.copy_(T(br))
    xt = T(x).requires_grad_()

    def body(xl):
        return row(nn.functional.gelu(col(xl)))

    P = M.P
    out = M.shard_map(body, mesh=mesh, in_specs=(P(),), out_specs=P())(xt)
    (out * T(ct)).sum().backward()
    res = {"out": out, "dx": xt.grad, "dwc": col.inner.weight.grad,
           "dbc": col.inner.bias.grad, "dwr": row.inner.weight.grad,
           "dbr": row.bias.grad}
    emb = MP.VocabParallelEmbedding(emb_w.shape[0], emb_w.shape[1])
    per = emb_w.shape[0] // tp
    with torch.no_grad():
        emb.inner.weight.copy_(T(emb_w[r * per:(r + 1) * per]))
    ids_t = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    e = M.shard_map(emb, mesh=mesh, in_specs=(P(),), out_specs=P())(ids_t)
    (e * T(emb_ct)).sum().backward()
    res.update(emb=e, demb=emb.inner.weight.grad)
    M.reset_mesh()
    return res


def dp_case(w1, b1, w2, b2, x, y, x2, y2):
    """DataParallel of Linear -> tanh -> Linear over a dp mesh of the
    world on the global batch ``x``: the loss mean((f(x) - y)^2) on the
    gathered outputs, one backward; returns the loss, the parameters'
    gradients (summed over dp at the end of the backward) and the bytes
    that the gradient all-reduce moved. Then ``apply_collective_grads``
    (a no-op after a backward) and a second backward on ``x2``, ``y2``
    without clearing, whose gradients add to the first's."""
    from .. import nn
    from ..distributed import mesh as M
    from ..distributed.parallel import DataParallel
    dev = _dev()
    M.init_mesh({"dp": M.world_size()})
    net = nn.Sequential(nn.Linear(w1.shape[0], w1.shape[1]), nn.Tanh(),
                        nn.Linear(w2.shape[0], w2.shape[1]))

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def grads():
        return [p.grad.detach().clone() for p in net.parameters()]

    with torch.no_grad():
        for p, a in zip(net.parameters(), (w1, b1, w2, b2)):
            p.copy_(T(a))
    model = DataParallel(net)
    out = model(T(x))
    loss = ((out - T(y)) ** 2).mean()
    loss.backward()
    res = {"loss": loss, "out": out, "grads": grads(),
           "allreduce_bytes": model.allreduce_bytes}
    model.apply_collective_grads()
    res["grads_after_apply"] = grads()
    ((model(T(x2)) - T(y2)) ** 2).mean().backward()
    res["grads_accumulated"] = grads()
    M.reset_mesh()
    return res


def parity_suite(attn, tp, dp):
    """``collectives_battery``, ``attention_case(*attn)``,
    ``tp_case(*tp)`` and ``dp_case(*dp)`` in one run of the ranks."""
    return {"collectives": collectives_battery(),
            "attention": attention_case(*attn), "tp": tp_case(*tp),
            "dp": dp_case(*dp)}
