"""Port parity: MoE (paddle_tpu_torch/distributed/moe.py) and the
synchronized batch norm (``ops.batch_norm(sync_axis=...)``,
``nn.SyncBatchNorm``) against the JAX package's.

The JAX package runs MoELayer under ``shard_map`` over ep 4 (each device
2 of 8 experts, its own tokens) and ``batch_norm(sync_axis="dp")`` over
dp 4, differentiated by ``jax.grad``; the port runs 4 gloo ranks
(``testing.spmd.run_ranks``, one spawn for the file): each rank loads the
JAX layer's whole expert stacks through the bridge (its 2 experts),
routes its tokens and moves them with the differentiable all_to_all.
The gate is replicated: its gradient is the sum of the ranks' shares,
as is BN's weight and bias gradient. Tolerances (f32): outputs rtol
1e-5 atol 1e-6, gradients rtol 1e-4 atol 1e-6 (the expert FFN's
einsums and the moments' sums in other orders); routing, capacity and
the dropped-token counts exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jp
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed import moe as JMOE
from paddle_tpu.ops import norm_ops as JN
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed import moe as TMOE
from paddle_tpu_torch.testing import spmd, spmd_train

N, E, DM, DH = 4, 8, 8, 16
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
EXPERTS = ("w_up", "b_up", "w_down", "b_down")


def _moe_inputs():
    rng = np.random.RandomState(5)
    params = {"gate.weight": (rng.randn(DM, E) * 0.5).astype("float32"),
              "w_up": (rng.randn(E, DM, DH) * 0.1).astype("float32"),
              "b_up": (rng.randn(E, DH) * 0.1).astype("float32"),
              "w_down": (rng.randn(E, DH, DM) * 0.1).astype("float32"),
              "b_down": (rng.randn(E, DM) * 0.1).astype("float32")}
    x = rng.randn(N, 2, 6, DM).astype("float32")
    ct = rng.randn(N, 2, 6, DM).astype("float32")
    return params, x, ct


def _bn_inputs():
    rng = np.random.RandomState(7)
    x = (rng.randn(8, 3, 4, 4) * 2 + 1).astype("float32")
    ct = rng.randn(8, 3, 4, 4).astype("float32")
    return x, ct, (rng.rand(3) + 0.5).astype("float32"), \
        rng.randn(3).astype("float32")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spmd.run_ranks(spmd_train.moe_bn_suite, N, _moe_inputs(),
                          _bn_inputs(),
                          tmp_path=tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def jax_moe():
    """JAX's MoELayer at ep 4 under shard_map, the tokens sharded by
    rank: output, dx and the parameters' gradients."""
    params, x, ct = _moe_inputs()
    mesh = JM.init_mesh({"ep": N}, name="default")
    jp.seed(0)
    moe = JMOE.MoELayer(DM, DH, E, axis="ep")
    specs = {k: (JP("ep") if k in EXPERTS else JP()) for k in params}
    xg = jnp.asarray(x.reshape(N * 2, 6, DM))
    ctg = jnp.asarray(ct.reshape(N * 2, 6, DM))

    def spmd_fn(p, xv):
        moe.load_functional_state(p)
        return moe(jp.Tensor(xv, _internal=True))._value

    def loss(p, xv):
        out = JM.shard_map(spmd_fn, mesh=mesh, in_specs=(specs, JP("ep")),
                           out_specs=JP("ep"))(p, xv)
        return jnp.sum(out * ctg), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, xg)
    JM.init_mesh({"dp": 8})
    return {"out": np.asarray(out).reshape(N, 2, 6, DM),
            "dx": np.asarray(gx).reshape(N, 2, 6, DM),
            **{k: np.asarray(v) for k, v in gp.items()}}


def test_moe_expert_parallel_matches_jax(port, jax_moe):
    for r in range(N):
        np.testing.assert_allclose(port[r]["moe"]["out"], jax_moe["out"][r],
                                   **OUT_TOL)
        np.testing.assert_allclose(port[r]["moe"]["dx"], jax_moe["dx"][r],
                                   **GRAD_TOL)
    for k in EXPERTS:       # rank r's experts are rows [2r, 2r + 2)
        np.testing.assert_allclose(
            np.concatenate([port[r]["moe"][k] for r in range(N)]),
            jax_moe[k], **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(sum(p["moe"]["gate"] for p in port),
                               jax_moe["gate.weight"], **GRAD_TOL)


def test_moe_dense_fallback_matches_jax(port):
    """Outside a region every expert runs locally: the layer over each
    rank's tokens against JAX's dense layer over the same."""
    params, x, ct = _moe_inputs()
    JM.init_mesh({"dp": 8})
    moe = JMOE.MoELayer(DM, DH, E, axis="ep")
    for r in range(N):
        def loss(p, xv):
            moe.load_functional_state(p)
            out = moe(jp.Tensor(xv, _internal=True))._value
            return jnp.sum(out * ct[r]), out
        (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(x[r]))
        dense = port[r]["moe"]["dense"]
        np.testing.assert_allclose(dense["out"], np.asarray(out), **OUT_TOL)
        np.testing.assert_allclose(dense["dx"], np.asarray(gx), **GRAD_TOL)
        np.testing.assert_allclose(dense["w_up"], np.asarray(gp["w_up"]),
                                   **GRAD_TOL)
        np.testing.assert_allclose(dense["gate"],
                                   np.asarray(gp["gate.weight"]), **GRAD_TOL)
        # the ep layer routes a rank's tokens as the dense one does
        np.testing.assert_allclose(port[r]["moe"]["out"], dense["out"],
                                   **OUT_TOL)


@pytest.mark.parametrize("T,cap", [(12, 2), (32, 5), (16, 16)])
def test_switch_route_and_dropped_tokens_equal_jax(T, cap):
    rng = np.random.RandomState(T)
    logits = rng.randn(T, E).astype("float32")
    jd, jc = JMOE.switch_route(jnp.asarray(logits), E, cap)
    before = monitor.stat_get("moe.dropped_tokens")
    td, tc = TMOE.switch_route(torch.from_numpy(logits), E, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    routed = np.asarray(jd).sum()
    assert monitor.stat_get("moe.dropped_tokens") - before == T - routed


@pytest.fixture(scope="module")
def jax_bn():
    x, ct, w, b = _bn_inputs()
    mesh = JM.init_mesh({"dp": N}, name="default")
    rm, rv = jnp.zeros(3), jnp.ones(3)

    def body(xv, wv, bv):
        out, nm, nv = JN.batch_norm.raw(xv, rm, rv, wv, bv, training=True,
                                        momentum=0.9, epsilon=1e-5,
                                        data_format="NCHW", sync_axis="dp")
        return out, nm[None], nv[None]

    def loss(xv, wv, bv):
        out, nm, nv = JM.shard_map(body, mesh=mesh,
                                   in_specs=(JP("dp"), JP(), JP()),
                                   out_specs=(JP("dp"), JP("dp"), JP("dp")))(
            xv, wv, bv)
        return jnp.sum(out * ct), (out, nm, nv)

    (_, (out, nm, nv)), (gx, gw, gb) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    JM.init_mesh({"dp": 8})
    return {k: np.asarray(v) for k, v in dict(out=out, mean=nm, var=nv,
                                               dx=gx, dw=gw, db=gb).items()}


def test_sync_batch_norm_matches_jax(port, jax_bn):
    for r in range(N):
        bn = port[r]["sync_bn"]
        np.testing.assert_allclose(bn["out"], jax_bn["out"], **OUT_TOL)
        np.testing.assert_allclose(bn["dx"], jax_bn["dx"], **GRAD_TOL)
        np.testing.assert_allclose(bn["mean"], jax_bn["mean"][r], **OUT_TOL)
        np.testing.assert_allclose(bn["var"], jax_bn["var"][r], **OUT_TOL)
    np.testing.assert_allclose(sum(p["sync_bn"]["dw"] for p in port),
                               jax_bn["dw"], **GRAD_TOL)
    np.testing.assert_allclose(sum(p["sync_bn"]["db"] for p in port),
                               jax_bn["db"], **GRAD_TOL)
