"""Port parity: the pipeline schedules (paddle_tpu_torch/distributed/
pipeline.py) and ``PipelineLayer``'s schedule against the JAX package's
(tests/test_distributed.py's pipeline tests are the model).

The JAX package runs the schedules as one program under ``shard_map`` on
a pp 4 mesh of its CPU devices, differentiated by ``jax.grad``; the port
runs 4 gloo ranks (``testing.spmd.run_ranks``, one spawn for the file),
tick-synchronous, each rank holding its stage (tanh(h @ w_r); the
interleaved schedule two chunks a rank, 8 global stages), autograd over
the ticks with the ppermutes' backward the inverse permutation.
Tolerances (f32, d 4): the losses rtol 1e-5 and the stage-weight and
input gradients rtol 1e-4 atol 1e-6 against JAX's pipeline and against
its sequential stack (the JAX tests' own rtol 1e-3 atol 1e-5 against
the sequential reference, narrowed: the port's sums are the same
products in another order); gpipe's forward outputs rtol 1e-5 atol
1e-6; the accounting functions exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import mesh as JM
from paddle_tpu.distributed import pipeline as JPL
from paddle_tpu_torch.distributed import pipeline as TPL
from paddle_tpu_torch.testing import spmd, spmd_train

from test_torch_jax_mesh import keeps_default_mesh

N, D = 4, 4
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _inputs():
    rng = np.random.RandomState(1)
    ws = (rng.randn(N, D, D) * 0.5).astype("float32")
    x = rng.randn(8, D).astype("float32")
    y = rng.randn(8, D).astype("float32")
    ws_v = (rng.randn(2 * N, D, D) * 0.5).astype("float32")
    return ws, x, y, ws_v


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spmd.run_ranks(spmd_train.pipeline_case, N, *_inputs(),
                          tmp_path=tmp_path_factory.mktemp("ranks"))


def _mb_loss(h, lbl):
    return jnp.mean((h - lbl) ** 2)


@keeps_default_mesh
def _jax_pipeline(stage_w, x, y, n_micro, schedule):
    """(loss, d stage weights, dx) of JAX's pipeline_loss under shard_map
    over pp 4; stage_w [N, D, D] or [N, v, D, D] (interleaved)."""
    mesh = JM.init_mesh({"pp": N}, name="default")
    ym = JPL.micro_batch(y, n_micro)

    def spmd_loss(w, xm_l, ym_l):
        if schedule == "interleaved":
            stage = [lambda h, c=c: jnp.tanh(h @ w[0, c])
                     for c in range(w.shape[1])]
        else:
            stage = lambda h: jnp.tanh(h @ w[0])  # noqa: E731
        return JPL.pipeline_loss(stage, _mb_loss, xm_l, ym_l, axis="pp",
                                 schedule=schedule)

    def outer(w, x_):
        return JM.shard_map(
            spmd_loss, mesh=mesh, in_specs=(JP("pp"), JP(), JP()),
            out_specs=JP())(w, JPL.micro_batch(x_, n_micro), ym).mean()

    loss, (gw, gx) = jax.jit(jax.value_and_grad(outer, argnums=(0, 1)))(
        jnp.asarray(stage_w), jnp.asarray(x))
    return float(loss), np.asarray(gw), np.asarray(gx)


def _sequential(ws, x, y, act=True):
    def loss(w, x_):
        h = x_
        for i in range(w.shape[0]):
            h = h @ w[i]
            h = jnp.tanh(h) if act else h
        return jnp.mean((h - y) ** 2), h

    (l, h), (gw, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(jnp.asarray(ws),
                                                        jnp.asarray(x))
    return float(l), np.asarray(gw), np.asarray(gx), np.asarray(h)


def test_gpipe_outputs_match_sequential(port):
    ws, x, y, _ = _inputs()
    *_, h = _sequential(ws, x, y)
    np.testing.assert_allclose(port[N - 1]["gpipe_outs"].reshape(8, D), h,
                               rtol=1e-5, atol=1e-6)
    for r in range(N - 1):          # zeros off the last stage
        assert not port[r]["gpipe_outs"].any()


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipeline_loss_and_grads_match_jax(port, schedule, n_micro):
    ws, x, y, _ = _inputs()
    loss, gw, gx = _jax_pipeline(ws, x, y, n_micro, schedule)
    sl, sgw, sgx, _ = _sequential(ws, x, y)
    np.testing.assert_allclose(loss, sl, rtol=LOSS_RTOL)
    case = f"{schedule}_m{n_micro}"
    for r in range(N):
        np.testing.assert_allclose(float(port[r][case]["loss"]), loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(port[r][case]["dw"], gw[r], **GRAD_TOL)
        np.testing.assert_allclose(port[r][case]["dw"], sgw[r], **GRAD_TOL)
    # the input's gradient reaches stage 0 through the permutes' transpose
    np.testing.assert_allclose(port[0][case]["dx"], gx, **GRAD_TOL)
    np.testing.assert_allclose(port[0][case]["dx"], sgx, **GRAD_TOL)


def test_interleaved_loss_and_grads_match_jax(port):
    ws, x, y, ws_v = _inputs()
    by_rank = np.stack([np.stack([ws_v[c * N + r] for c in range(2)])
                        for r in range(N)])
    loss, gw, gx = _jax_pipeline(by_rank, x, y, N, "interleaved")
    sl, sgw, _, _ = _sequential(ws_v, x, y)
    np.testing.assert_allclose(loss, sl, rtol=LOSS_RTOL)
    for r in range(N):
        rec = port[r]["interleaved"]
        np.testing.assert_allclose(float(rec["loss"]), loss, rtol=LOSS_RTOL)
        for c in range(2):
            np.testing.assert_allclose(rec["dw"][c], gw[r, c], **GRAD_TOL)
            np.testing.assert_allclose(rec["dw"][c], sgw[c * N + r],
                                       **GRAD_TOL)
    np.testing.assert_allclose(port[0]["interleaved"]["dx"], gx, **GRAD_TOL)


@pytest.mark.parametrize("v", [1, 2])
def test_pipeline_layer_schedule_matches_sequential(port, v):
    """PipelineLayer's 1f1b (v 1) and interleaved (v 2) schedules of 8
    bias-free Linear layers: the loss on every rank and each rank's
    stages' gradients against JAX's gradient of the sequential stack."""
    _, x, y, ws_v = _inputs()
    sl, sgw, _, _ = _sequential(ws_v, x, y, act=False)
    per = len(ws_v) // (N * v)
    for r in range(N):
        rec = port[r]["pipeline_layer"][f"v{v}"]
        np.testing.assert_allclose(float(rec["loss"]), sl, rtol=LOSS_RTOL)
        mine = [c * N + r for c in range(v)]
        for chunk in mine:
            for i in range(chunk * per, (chunk + 1) * per):
                np.testing.assert_allclose(rec["grads"][i], sgw[i],
                                           **GRAD_TOL)


@pytest.mark.parametrize("M,n,schedule,v", [
    (0, 4, "gpipe", 1), (1, 1, "gpipe", 1), (2, 8, "gpipe", 1),
    (8, 4, "1f1b", 1), (8, 4, "interleaved", 2), (3, 4, "interleaved", 3),
    (16, 8, "gpipe", 2)])
def test_schedule_accounting_equals_jax(M, n, schedule, v):
    assert TPL.schedule_ticks(M, n, schedule, v) == \
        JPL.schedule_ticks(M, n, schedule, v)
    assert TPL.bubble_fraction(M, n, schedule, v) == \
        JPL.bubble_fraction(M, n, schedule, v)
    tiers = {"pp": {"tier": "dcn", "gbps": 25.0}}
    for t in (None, tiers):
        assert TPL.schedule_collectives(M, n, 4096, schedule, v,
                                        tiers=t) == \
            JPL.schedule_collectives(M, n, 4096, schedule, v, tiers=t)


def test_micro_batch_and_errors():
    import torch
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(
        TPL.micro_batch(torch.from_numpy(x), 4).numpy(),
        np.asarray(JPL.micro_batch(jnp.asarray(x), 4)))
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        TPL.gpipe(lambda h: h, torch.zeros(2, 1, 3), schedule="zb")


def test_pipeline_layer_bridge_and_sequential_forward_equal_jax():
    """A JAX PipelineLayer's stage parameters carried across by the
    bridge (``stages.{i}.{j}...``): the port's layer outside a pp region
    runs the stages in turn, as JAX's forward does, to the same output."""
    import torch
    import paddle_tpu as jp
    from paddle_tpu import nn as jnn
    from paddle_tpu.distributed.fleet import meta_parallel as JMP
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.bridge import load_jax_params
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.distributed.fleet import meta_parallel as TMP
    jp.seed(2)
    descs = [(jnn.Linear, tnn.Linear), (jnn.Tanh, tnn.Tanh)] * 4
    jpipe = JMP.PipelineLayer([JMP.LayerDesc(j, *((D, D) if j is jnn.Linear
                                                   else ()))
                               for j, _ in descs], num_stages=N)
    with device_scope("cpu"):
        tpipe = TMP.PipelineLayer([TMP.LayerDesc(t, *((D, D)
                                                     if t is tnn.Linear
                                                     else ()))
                                   for _, t in descs], num_stages=N)
    params = {k: np.asarray(v)
              for k, v in jpipe.functional_state()[0].items()}
    assert set(params) == {k for k, _ in tpipe.named_parameters()}
    load_jax_params(tpipe, params)
    x = np.random.RandomState(4).randn(5, D).astype("float32")
    want = np.asarray(jpipe(jp.to_tensor(x))._value)
    got = tpipe(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
