"""Port parity: the collective tier (paddle_tpu_torch/distributed) against
the JAX package's (tests/test_distributed.py is the model).

The JAX package runs its collectives in one process over the 8-device CPU
mesh (tests/conftest.py); the port runs one process per mesh position, so
its side runs as 4 gloo ranks through ``testing.spmd.run_ranks`` (one
spawn for the whole file, ``parity_suite``), every rank holding the
global inputs, and the results come back as numpy. Tolerances:
- collectives on integer-valued f32: exact (JAX's results, and numpy's
  for send / recv, which JAX does not have);
- ring and Ulysses attention (f32, sp 4) against JAX's
  ``sequence_parallel_attention``: rtol 2e-4, atol 2e-5, the JAX test's
  own limits against dense attention (the port merges flash blocks, JAX
  the einsum blocks, in another order);
- the tensor-parallel MLP and VocabParallelEmbedding (tp 4): outputs
  against JAX's layers under shard_map, gradients against JAX's gradient
  of the dense layers, rtol 1e-5 atol 1e-6 (f32 sums split across ranks);
- DataParallel (dp 4): loss and gradients against JAX's DataParallel on a
  dp 4 mesh, rtol 1e-5 atol 1e-6, also after an explicit
  apply_collective_grads and after a second backward that accumulates;
- recompute: the port's gradients bitwise its own without recompute, and
  against JAX's within rtol 1e-4 atol 1e-5 (f32 matmul, gelu and tanh in
  XLA and in torch: 4.5e-5 relative at most here, with or without
  recompute); the sharding tables spec for spec.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed import sharding as JS
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.distributed import collective as TC
from paddle_tpu_torch.distributed import mesh as TM
from paddle_tpu_torch.distributed import sharding as TS
from paddle_tpu_torch.testing import spmd
from test_torch_jax_mesh import keeps_default_mesh

N = 4
K = 8
B, H, S, D = 1, 4, 32, 8
IN, HID, OUT, V, ED = 8, 16, 8, 16, 4


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _attn_inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(B, H, S, D).astype("float32") for _ in range(3)]


def _tp_inputs():
    rng = np.random.RandomState(3)
    x = rng.randn(4, IN).astype("float32")
    wc = (rng.randn(IN, HID) * 0.3).astype("float32")
    bc = (rng.randn(HID) * 0.1).astype("float32")
    wr = (rng.randn(HID, OUT) * 0.3).astype("float32")
    br = (rng.randn(OUT) * 0.1).astype("float32")
    ct = rng.randn(4, OUT).astype("float32")
    emb_w = rng.randn(V, ED).astype("float32")
    ids = rng.randint(0, V, (3, 5)).astype("int64")
    emb_ct = rng.randn(3, 5, ED).astype("float32")
    return x, wc, bc, wr, br, ct, emb_w, ids, emb_ct


def _dp_inputs():
    rng = np.random.RandomState(5)
    return ((rng.randn(6, 12) * 0.4).astype("float32"),
            (rng.randn(12) * 0.1).astype("float32"),
            (rng.randn(12, 3) * 0.4).astype("float32"),
            (rng.randn(3) * 0.1).astype("float32"),
            rng.randn(8, 6).astype("float32"),
            rng.randn(8, 3).astype("float32"),
            rng.randn(8, 6).astype("float32"),
            rng.randn(8, 3).astype("float32"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results of the whole suite, from one run of 4 ranks."""
    return spmd.run_ranks(spmd.parity_suite, N, _attn_inputs(),
                          _tp_inputs(), _dp_inputs(),
                          tmp_path=tmp_path_factory.mktemp("ranks"))


def _ranks(port, part, key):
    return np.stack([np.asarray(r[part][key]) for r in port])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
@keeps_default_mesh
def jax_collectives():
    """The battery's cases through the JAX package's collectives under
    shard_map on a 4-device mesh: {case: [rank, ...]}."""
    mesh = JM.init_mesh({"dp": N}, name="default")
    xs = jnp.stack([jnp.arange(K, dtype=jnp.float32) + 3 * r
                    for r in range(N)])
    signed = jnp.stack([jnp.asarray([r - 1.0, 2.0, -1.0,
                                     0.0 if r == 2 else 1.5])
                        for r in range(N)])
    rs_in = jnp.stack([jnp.arange(4 * N, dtype=jnp.float32) * (r + 1)
                       for r in range(N)])
    a2a_in = jnp.stack([jnp.arange(N * 3, dtype=jnp.float32).reshape(N, 3)
                        + 100 * r for r in range(N)])
    sc_in = jnp.stack([jnp.arange(N * 2, dtype=jnp.float32).reshape(N, 2)
                       + 10 * r for r in range(N)])

    def body(x, sg, rs, a2a, sc):
        x, sg, rs, a2a, sc = x[0], sg[0], rs[0], a2a[0], sc[0]
        out = {}
        for op in ("sum", "max", "min", "avg"):
            out[f"all_reduce_{op}"] = JC._allreduce_raw.raw(x, "dp", op)
        out["all_reduce_prod"] = JC._allreduce_raw.raw(sg, "dp", "prod")
        groups = ((0, 1, 2), (3,))
        out["subgroup_sum"] = JC._allreduce_raw.raw(x, "dp", "sum", groups)
        out["subgroup_max"] = JC._allreduce_raw.raw(x, "dp", "max", groups)
        out["subgroup_prod"] = JC._allreduce_raw.raw(sg, "dp", "prod",
                                                     groups)
        out["all_gather"] = JC._allgather_raw.raw(x, "dp")
        out["reduce"] = JC._reduce_raw.raw(x, "dp", "sum", 1)
        out["reduce_scatter"] = JC._reduce_scatter_raw.raw(rs, "dp", "sum")
        out["reduce_scatter_max"] = JC._reduce_scatter_raw.raw(rs, "dp",
                                                               "max")
        out["reduce_scatter_avg"] = JC._reduce_scatter_raw.raw(rs, "dp",
                                                               "avg")
        out["reduce_scatter_prod"] = JC._reduce_scatter_raw.raw(sg, "dp",
                                                                "prod")
        out["reduce_scatter_via_all_reduce"] = out["reduce_scatter"]
        out["alltoall"] = JC._alltoall_raw.raw(a2a, "dp")
        out["broadcast"] = JC._broadcast_raw.raw(x, "dp", 3)
        out["broadcast_sub"] = JC._broadcast_raw.raw(x, "dp", 2, (1, 2, 3))
        out["scatter"] = JC._scatter_raw.raw(sc, "dp", 1)
        out["ppermute"] = JC._ppermute_raw.raw(
            x, "dp", tuple((i, (i + 1) % N) for i in range(N)))
        return {k: v[None] for k, v in out.items()}

    res = jax.jit(JM.shard_map(body, mesh=mesh, in_specs=JP("dp"),
                               out_specs=JP("dp")))(xs, signed, rs_in,
                                                    a2a_in, sc_in)
    hmesh = JM.init_mesh({"pod": {"size": 2, "tier": "dcn"}, "dp": 2},
                         name="hier")

    def hbody(x):
        x = x[0]
        return {"hierarchical_sum": JC._hierarchical_allreduce_raw.raw(
                    x, "dp", "pod", "sum")[None],
                "hierarchical_avg": JC._hierarchical_allreduce_raw.raw(
                    x[:5], "dp", "pod", "avg")[None],
                "hierarchical_max": JC._hierarchical_allreduce_raw.raw(
                    x, "dp", "pod", "max")[None]}

    res.update(jax.jit(JM.shard_map(hbody, mesh=hmesh,
                                    in_specs=JP(("pod", "dp")),
                                    out_specs=JP(("pod", "dp"))))(xs))
    # each device's value gathered over (dp, pod), the reverse of the
    # mesh's axis order; every rank of the port returns the whole
    g = JM.shard_map(lambda x: x, mesh=hmesh, in_specs=JP(("pod", "dp")),
                     out_specs=JP(("dp", "pod")))(xs)
    res["gather_dp_pod"] = jnp.stack([g] * N)
    tiers = JM.axis_tiers(hmesh)
    return {k: np.asarray(v) for k, v in res.items()}, tiers


REDUCE_CASES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
                "all_reduce_avg", "all_reduce_prod", "subgroup_sum",
                "subgroup_max", "subgroup_prod"]
MOVE_CASES = ["all_gather", "reduce", "reduce_scatter",
              "reduce_scatter_max", "reduce_scatter_avg",
              "reduce_scatter_prod", "reduce_scatter_via_all_reduce",
              "alltoall",
              "broadcast", "broadcast_sub", "scatter", "ppermute"]
HIER_CASES = ["hierarchical_sum", "hierarchical_avg", "hierarchical_max",
              "gather_dp_pod"]


@pytest.mark.parametrize("case", REDUCE_CASES + MOVE_CASES + HIER_CASES)
def test_collective_equals_jax_exactly(port, jax_collectives, case):
    got = _ranks(port, "collectives", case)
    want = jax_collectives[0][case]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_send_recv_pairs_and_tiers(port, jax_collectives):
    got = _ranks(port, "collectives", "send_recv")
    x = np.stack([np.arange(K, dtype=np.float32) + 3 * r for r in range(N)])
    want = np.zeros_like(x)
    want[1], want[3] = x[0], x[2]
    np.testing.assert_array_equal(got, want)
    tiers = port[0]["collectives"]["tiers"]
    assert [t["tier"] for t in tiers.values()] == \
        [t["tier"] for t in jax_collectives[1].values()] == ["dcn", "ici"]
    # CPU tensors need no staging: the transport table stays empty
    assert port[0]["collectives"]["transport"] == {}
    # on the host only reduce-scatter is probed: gloo lacks it on some
    # torch versions
    cpu = port[0]["collectives"]["transport_cpu"]
    assert cpu.pop("reduce_scatter") in ("native", "all_reduce")
    assert set(cpu.values()) == {"native"}


# ---------------------------------------------------------------------------
# ring and Ulysses attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
@keeps_default_mesh
def jax_attention():
    from paddle_tpu.distributed.ring_attention import \
        sequence_parallel_attention
    mesh = JM.init_mesh({"sp": N}, name="default")
    q, k, v = (jnp.asarray(a) for a in _attn_inputs())
    out = {}
    for mode in ("ring", "ulysses"):
        for causal in (False, True):
            def attention(q, k, v):
                return sequence_parallel_attention(
                    *(jp.Tensor(t, _internal=True) for t in (q, k, v)),
                    mesh=mesh, causal=causal, mode=mode)._value
            out[f"{mode}_causal{int(causal)}"] = np.asarray(
                jax.jit(attention)(q, k, v))
    return out


@pytest.mark.parametrize("case", ["ring_causal0", "ring_causal1",
                                  "ulysses_causal0", "ulysses_causal1"])
def test_sequence_parallel_attention_matches_jax(port, jax_attention, case):
    for r in range(N):      # every rank returns the global result
        np.testing.assert_allclose(port[r]["attention"][case],
                                   jax_attention[case], rtol=2e-4,
                                   atol=2e-5)


def test_causal_ring_skips_the_later_ranks_blocks(port):
    # rank r skips the n - 1 - r blocks of later ranks: 6 of 16 at sp 4
    skipped = [r["attention"]["ring_causal1_stats"]["skipped"] for r in port]
    assert skipped == [3, 2, 1, 0]
    assert [r["attention"]["ring_causal0_stats"]["skipped"] for r in port] \
        == [0] * N
    assert all(r["attention"]["ring_causal1_stats"]["steps"] == N
               for r in port)


# ---------------------------------------------------------------------------
# tensor and data parallel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
@keeps_default_mesh
def jax_tp():
    """JAX's ColumnParallelLinear + gelu + RowParallelLinear and
    VocabParallelEmbedding under shard_map, each device holding its shards
    (seated through load_functional_state), and jax.grad of the dense
    layers."""
    from paddle_tpu.distributed.fleet import meta_parallel as JMP
    x, wc, bc, wr, br, ct, emb_w, ids, emb_ct = _tp_inputs()
    mesh = JM.init_mesh({"tp": N}, name="default")
    col = JMP.ColumnParallelLinear(IN, HID, gather_output=False)
    row = JMP.RowParallelLinear(HID, OUT, input_is_parallel=True)
    emb = JMP.VocabParallelEmbedding(V, ED)

    def body(wc_l, bc_l, wr_l, br_, x_):
        col.inner.load_functional_state({"weight": wc_l, "bias": bc_l})
        row.inner.load_functional_state({"weight": wr_l})
        row.load_functional_state({"bias": br_})
        h = jp.nn.functional.gelu(col(jp.Tensor(x_, _internal=True)))
        return row(h)._value

    out = jax.jit(JM.shard_map(body, mesh=mesh,
                               in_specs=(JP(None, "tp"), JP("tp"),
                                         JP("tp", None), JP(), JP()),
                               out_specs=JP()))(wc, bc, wr, br, x)

    def ebody(w_l, ids_):
        emb.inner.load_functional_state({"weight": w_l})
        return emb(jp.Tensor(ids_, _internal=True))._value

    e = jax.jit(JM.shard_map(ebody, mesh=mesh,
                             in_specs=(JP("tp", None), JP()),
                             out_specs=JP()))(emb_w, ids)

    def dense(wc, bc, wr, br, x):
        return jnp.sum((jax.nn.gelu(x @ wc + bc, approximate=False) @ wr
                        + br) * ct)

    grads = jax.grad(dense, argnums=(0, 1, 2, 3, 4))(wc, bc, wr, br, x)
    demb = jax.grad(lambda w: jnp.sum(w[ids] * emb_ct))(emb_w)
    return {"out": np.asarray(out), "emb": np.asarray(e),
            "grads": [np.asarray(g) for g in grads],
            "demb": np.asarray(demb)}


def test_tensor_parallel_outputs_match_jax(port, jax_tp):
    for r in range(N):
        np.testing.assert_allclose(port[r]["tp"]["out"], jax_tp["out"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port[r]["tp"]["emb"], jax_tp["emb"],
                                   rtol=1e-5, atol=1e-6)


def test_tensor_parallel_gradients_match_jax(port, jax_tp):
    dwc, dbc, dwr, dbr, dx = jax_tp["grads"]
    got = {k: np.concatenate([r["tp"][k] for r in port], axis=a)
           for k, a in (("dwc", 1), ("dbc", 0), ("dwr", 0))}
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["dwc"], dwc, **tol)
    np.testing.assert_allclose(got["dbc"], dbc, **tol)
    np.testing.assert_allclose(got["dwr"], dwr, **tol)
    for r in range(N):
        np.testing.assert_allclose(port[r]["tp"]["dbr"], dbr, **tol)
        np.testing.assert_allclose(port[r]["tp"]["dx"], dx, **tol)
    demb = np.concatenate([r["tp"]["demb"] for r in port])
    np.testing.assert_allclose(demb, jax_tp["demb"], **tol)


@pytest.fixture(scope="module")
@keeps_default_mesh
def jax_dp():
    from paddle_tpu.distributed.parallel import DataParallel
    w1, b1, w2, b2, x, y, x2, y2 = _dp_inputs()
    JM.init_mesh({"dp": N}, name="default")
    net = jp.nn.Sequential(jp.nn.Linear(6, 12), jp.nn.Tanh(),
                           jp.nn.Linear(12, 3))
    for p, a in zip(net.parameters(), (w1, b1, w2, b2)):
        p.set_value(a)
    model = DataParallel(net)
    out = model(jp.to_tensor(x))
    loss = ((out - jp.to_tensor(y)) ** 2).mean()
    loss.backward()
    res = {"loss": float(loss.numpy()), "out": out.numpy(),
           "grads": [p.grad.numpy() for p in net.parameters()]}
    model.apply_collective_grads()
    res["grads_after_apply"] = [p.grad.numpy() for p in net.parameters()]
    ((model(jp.to_tensor(x2)) - jp.to_tensor(y2)) ** 2).mean().backward()
    res["grads_accumulated"] = [p.grad.numpy() for p in net.parameters()]
    return res


def test_data_parallel_loss_and_grads_match_jax(port, jax_dp):
    tol = dict(rtol=1e-5, atol=1e-6)
    for r in range(N):
        d = port[r]["dp"]
        np.testing.assert_allclose(d["loss"], jax_dp["loss"], **tol)
        np.testing.assert_allclose(d["out"], jax_dp["out"], **tol)
        # after the backward, apply_collective_grads changes nothing, and
        # a second backward adds its global gradients to the first's
        for key in ("grads", "grads_after_apply", "grads_accumulated"):
            for g, w in zip(d[key], jax_dp[key]):
                np.testing.assert_allclose(g, w, **tol)
        # one flattened f32 all-reduce of the 6*12 + 12 + 12*3 + 3 grads
        assert d["allreduce_bytes"] == 4 * (72 + 12 + 36 + 3)


# ---------------------------------------------------------------------------
# one process: recompute, the rule tables, the world of one
# ---------------------------------------------------------------------------

def test_recompute_gradients_match_jax():
    from paddle_tpu.distributed.recompute import recompute as jrec
    from paddle_tpu_torch.distributed import recompute as trec
    rng = np.random.RandomState(7)
    w1, w2 = rng.randn(6, 10).astype("float32"), \
        rng.randn(10, 6).astype("float32")
    x = rng.randn(4, 6).astype("float32")
    got = {}
    for name, pkg, rec in (("jax", jp, jrec), ("port", tp, trec)):
        a, b = pkg.to_tensor(w1), pkg.to_tensor(w2)
        a.stop_gradient = b.stop_gradient = False
        xt = pkg.to_tensor(x)

        def block(h):
            return pkg.nn.functional.gelu(pkg.matmul(h, a)).matmul(b).tanh()

        loss = (rec(block, xt) ** 2).sum()
        loss.backward()
        got[name] = (float(loss.numpy()), a.grad.numpy(), b.grad.numpy())
        if name == "port":
            ga, gb = a.grad.numpy().copy(), b.grad.numpy().copy()
            a.clear_gradient()
            b.clear_gradient()
            (block(xt) ** 2).sum().backward()
            np.testing.assert_array_equal(ga, a.grad.numpy())
            np.testing.assert_array_equal(gb, b.grad.numpy())
    np.testing.assert_allclose(got["port"][0], got["jax"][0], rtol=1e-6)
    for g, w in zip(got["port"][1:], got["jax"][1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_recompute_under_amp_casts_as_the_forward():
    """G5: the recomputation runs under the forward's AMP policy (O1 bf16
    here): the gradients bitwise the plain backward's, and the loss as
    JAX's under its own auto_cast (bf16 matmuls: rtol 1e-2)."""
    from paddle_tpu.distributed.recompute import recompute as jrec
    from paddle_tpu_torch.distributed import recompute as trec
    rng = np.random.RandomState(9)
    w1, w2 = rng.randn(6, 10).astype("float32"), \
        rng.randn(10, 6).astype("float32")
    x = rng.randn(4, 6).astype("float32")
    losses = {}
    for name, pkg, rec in (("jax", jp, jrec), ("port", tp, trec)):
        grads = []
        for use in (True, False):
            a, b = pkg.to_tensor(w1), pkg.to_tensor(w2)
            a.stop_gradient = b.stop_gradient = False
            xt = pkg.to_tensor(x)

            def block(h):
                return pkg.matmul(pkg.nn.functional.gelu(pkg.matmul(h, a)),
                                  b)
            with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
                out = rec(block, xt) if use else block(xt)
                loss = (out.astype("float32") ** 2).sum()
            loss.backward()
            grads.append((a.grad.numpy(), b.grad.numpy()))
            losses[name, use] = float(loss.numpy())
        if name == "port":
            for g1, g2 in zip(*grads):
                np.testing.assert_array_equal(g1, g2)
    np.testing.assert_allclose(losses["port", True], losses["jax", True],
                               rtol=1e-2)


def test_recompute_recomputes_and_policies():
    from paddle_tpu_torch.distributed.recompute import (checkpoint_policy,
                                                        recompute)
    calls = []

    def block(h):
        calls.append(1)
        return torch.tanh(h * 2.0)

    x = torch.randn(3, requires_grad=True)
    recompute(block, x).sum().backward()
    assert len(calls) == 2            # the forward ran again in backward
    assert checkpoint_policy("nothing") is None
    assert callable(checkpoint_policy("dots"))
    with pytest.raises(NotImplementedError, match="batch dims"):
        checkpoint_policy("dots_no_batch")
    with pytest.raises(ValueError):
        checkpoint_policy("bogus")
    y = torch.randn(3, requires_grad=True)
    recompute(block, y, policy="dots").sum().backward()
    np.testing.assert_allclose(y.grad.numpy(),
                               (2 * (1 - torch.tanh(2 * y) ** 2))
                               .detach().numpy(), rtol=1e-6, atol=1e-6)


RULE_CASES = [
    ("encoder.layers.0.self_attn.q_proj.weight", 2),
    ("encoder.layers.0.self_attn.q_proj.bias", 1),
    ("encoder.layers.0.self_attn.out_proj.weight", 2),
    ("encoder.layers.0.linear1.weight", 2),
    ("encoder.layers.0.linear2.weight", 2),
    ("embeddings.word_embeddings.weight", 2),
    ("gpt.wte.weight", 2), ("mlm_transform.bias", 1),
    ("encoder.layers.0.norm1.weight", 1), ("pooler.dense.weight", 2),
]


@pytest.mark.parametrize("zero_dp", [False, True])
def test_sharding_rule_tables_equal_jax(zero_dp):
    for shape in ({"dp": 2, "tp": 4}, {"dp": 8}):
        jm, tm = JS.mesh_like(shape), TS.mesh_like(shape)
        for name, ndim in RULE_CASES:
            j = JS.param_spec_for(name, ndim, jm, zero_dp=zero_dp)
            t = TS.param_spec_for(name, ndim, tm, zero_dp=zero_dp)
            assert tuple(t) == tuple(j), (name, shape, t, j)
            for sh in ((12, 8), (8, 12), (6,), (8,)):
                if len(sh) >= len(tuple(j)):
                    assert tuple(TS._validate_divisible(t, sh, tm)) == \
                        tuple(JS._validate_divisible(j, sh, jm))


@keeps_default_mesh
def test_custom_rules_errors_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    for S, P in ((JS, JP), (TS, TS.P)):
        S.add_tp_rule(r"special\.weight$", P("tp", None))
        S.add_tp_rule(r"shaped\.", lambda nd: P(*([None] * (nd - 1)
                                                  + ["tp"])))
    m = {"dp": 2, "tp": 4}
    try:
        for name, nd in (("a.special.weight", 2), ("b.shaped.w", 3),
                         ("b.shaped.b", 1)):
            assert tuple(TS.param_spec_for(name, nd, TS.mesh_like(m))) == \
                tuple(JS.param_spec_for(name, nd, JS.mesh_like(m)))
        for S in (JS, TS):
            with pytest.raises(ValueError, match="tp rule"):
                S.param_spec_for("a.special.weight", 1, S.mesh_like(m))
            with pytest.raises(ValueError, match="entries"):
                S._validate_divisible(S.param_spec_for(
                    "x.q_proj.weight", 2, S.mesh_like(m)), (4,),
                    S.mesh_like(m))
    finally:
        assert JS.remove_tp_rule(r"special\.weight$") == 1
        assert TS.remove_tp_rule(r"special\.weight$") == 1
        JS.remove_tp_rule(r"shaped\.")
        TS.remove_tp_rule(r"shaped\.")
    spec = TS.param_spec_for("x.linear1.weight", 2, TS.mesh_like(m))
    assert TS.to_placements(spec, m) == (Replicate(), Shard(1))
    assert TS.to_placements(TS.P(("dp", "tp")), m) == (Shard(0), Shard(0))
    # 6 is not divisible by tp 4: the dim falls back to replication
    assert TS.to_placements(spec, m, shape=(8, 6)) == \
        (Replicate(), Replicate())
    # ZeRO's half: the specs of a parameter tree, tp rules first, the rest
    # of dim 0 over dp, non-dividing dims replicated, as JAX's
    JM.init_mesh({"dp": 2, "tp": 4}, name="zero")
    shapes = {"blocks.0.fc1.weight": (8, 16), "blocks.0.fc2.weight": (16, 8),
              "ln.weight": (8,), "odd.bias": (3,), "emb.weight": (6, 4)}
    jsh = JS.build_param_shardings({k: jnp.zeros(v) for k, v in
                                    shapes.items()}, JM.get_mesh("zero"),
                                   zero_dp=True)
    tsh = TS.build_param_shardings({k: torch.zeros(v) for k, v in
                                    shapes.items()}, m, zero_dp=True)
    for k in shapes:
        assert tuple(tsh[k].spec) == tuple(jsh[k].spec), k
    assert tsh["blocks.0.fc1.weight"].placements == (Replicate(), Shard(1))
    assert tsh["ln.weight"].placements == (Shard(0), Replicate())
    slots = TS.shard_optimizer_state({"ln.weight": {"moment1": 0}}, tsh)
    assert slots["ln.weight"]["moment1"] == tsh["ln.weight"]
    net, opt = torch.nn.Linear(2, 2), object.__new__(type("O", (), {}))
    assert TS.group_sharded_parallel(net, opt, "p_g_os")[0]._zero_dp
    assert opt._zero_dp
    with pytest.raises(ValueError, match="level"):
        TS.group_sharded_parallel(net, opt, "zero4")
    JM.reset_mesh("zero")


def test_world_of_one_is_the_identity():
    t = tp.to_tensor([1.0, 2.0])
    TM.init_mesh({"dp": 1}, name="single")
    out = TC.all_reduce(t, group=TC.Group("zz"))
    np.testing.assert_allclose(out.numpy(), [1.0, 2.0])
    lst = []
    TC.all_gather(lst, t)
    assert len(lst) == 1 and lst[0] is t
    assert TC.broadcast(t) is t and TC.reduce(t) is t
    assert TC.p2p_permute(t, [(0, 0)]) is t
    assert TC.all_gather_object([], {"a": 1}) == [{"a": 1}]
    # outside a region the attention is the dense one
    from paddle_tpu_torch.distributed import ring_attention as TR
    q = torch.randn(1, 2, 8, 4)
    ref = torch.nn.functional.scaled_dot_product_attention(q, q, q)
    np.testing.assert_allclose(TR.ring_attention(q, q, q).numpy(),
                               ref.numpy(), rtol=1e-5, atol=1e-6)
    # inside a region of one rank the sharded attention is the dense one,
    # and inputs that need a gradient get dense attention's (G3: the ring
    # no longer drops it)
    sp1 = TM.init_mesh({"sp": 1}, name="sp1")
    qd = q.clone().requires_grad_()
    torch.nn.functional.scaled_dot_product_attention(qd, q, q).sum() \
        .backward()
    with TM.MeshGuard(sp1):
        for fn in (TR.ring_attention, TR.ulysses_attention):
            qg = q.clone().requires_grad_()
            out = fn(qg, q, q)
            np.testing.assert_allclose(out.detach().numpy(), ref.numpy(),
                                       rtol=1e-5, atol=1e-6)
            out.sum().backward()
            np.testing.assert_allclose(qg.grad.numpy(), qd.grad.numpy(),
                                       rtol=1e-5, atol=1e-6)
            with torch.no_grad():
                fn(qg, q, q)
    # one process per mesh position: a mesh larger than the world raises
    with pytest.raises(ValueError, match="one process per mesh position"):
        TM.init_mesh({"dp": 8})
    TM.reset_mesh()


def test_bootstrap_backend_counts_the_node_ranks(monkeypatch):
    from paddle_tpu_torch.distributed import bootstrap as B
    eps = [f"10.0.0.{h}:{6170 + i}" for h in (1, 2) for i in range(4)]
    monkeypatch.delenv("PADDLE_LOCAL_SIZE", raising=False)
    assert B.local_ranks(5, 8, eps) == (4, 1)
    assert B.local_ranks(3, 4, []) == (4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert B.default_backend(4) == "nccl"     # 2 nodes x 4 cards
    assert B.default_backend(8) == "gloo"     # 8 ranks share 4 cards
    monkeypatch.setenv("PADDLE_LOCAL_SIZE", "2")
    monkeypatch.setenv("PADDLE_LOCAL_RANK", "1")
    assert B.local_ranks(5, 8, eps) == (2, 1)


def test_run_ranks_raises_with_the_failing_ranks_output(tmp_path):
    with pytest.raises(RuntimeError, match="invalid literal"):
        spmd.run_ranks(int, 2, "x", tmp_path=tmp_path)


def test_item_7b_names_raise():
    """Items 7b and 7c are ported: the training half's modules, the
    launcher, elastic training and the analyzer's rest import, and a name
    the package lacks is an AttributeError."""
    import paddle_tpu_torch.distributed as D
    for name in ("pipeline", "moe", "localsgd", "launch", "elastic"):
        assert getattr(D, name).__name__ == f"paddle_tpu_torch.distributed." \
            f"{name}"
    assert callable(D.launch.launch) and callable(D.elastic.Supervisor)
    from paddle_tpu_torch.distributed import fleet
    assert callable(fleet.init) and callable(fleet.distributed_optimizer)
    from paddle_tpu_torch.static import spmd_analyzer
    assert callable(spmd_analyzer.analyze_program)
    with pytest.raises(AttributeError):
        D.no_such_name
    assert D.InMemoryDataset is tp.io.fleet_dataset.InMemoryDataset


def test_registry_holds_the_collective_tier_names():
    import paddle_tpu.distributed.fleet.meta_parallel  # noqa: F401
    import paddle_tpu.distributed.ring_attention  # noqa: F401
    names = {"c_allreduce", "c_allgather", "c_reduce", "c_broadcast",
             "c_scatter", "c_alltoall", "c_reducescatter",
             "c_hierarchical_allreduce", "send_v2",
             "mp_allreduce_identity_bwd", "mp_identity_allreduce_bwd",
             "ring_attention", "ulysses_attention"}
    assert names <= set(tp.ops.OP_REGISTRY)
    assert names <= set(jp.ops.OP_REGISTRY)
    # the whole JAX registry but its four helpers (``fake_quant`` joins
    # once ``quantization`` is imported)
    assert len(set(tp.ops.OP_REGISTRY) - {"fake_quant"}) == 502
