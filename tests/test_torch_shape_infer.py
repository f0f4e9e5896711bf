"""Port parity: abstract shape inference (paddle_tpu_torch/static/
shape_infer.py) against paddle_tpu/static/shape_infer.py.

tests/test_shape_infer.py's cases run on both packages. On the ops of a
tiny BERT (with its fused MLM loss) and GPT program, built in each
package, the port's propagation gives JAX's shapes and dtypes op by op,
and every rule of the port agrees with its op's raw function run on meta
tensors (the fallback the rules stand in for). The kernel wrappers'
ops have rules because their wrappers take CPU or CUDA tensors only.
"""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.ops._dispatch import SHAPE_INFER_REGISTRY

from test_torch_static_cases import JAX, PKGS, PORT, static_mode


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


def _si(P):
    return __import__(P.static.__name__ + ".shape_infer",
                      fromlist=["infer_program"])


def _dt(d):
    return str(d).replace("torch.", "")


def test_rule_library_covers_at_least_25_ops():
    import paddle_tpu_torch.static.shape_infer  # noqa: F401
    assert len(SHAPE_INFER_REGISTRY) >= 25, sorted(SHAPE_INFER_REGISTRY)
    for must in ("matmul", "conv2d", "concat", "sum", "mean", "add",
                 "reshape", "transpose", "softmax", "embedding",
                 "flash_sdpa", "fused_ce_op"):
        assert must in SHAPE_INFER_REGISTRY


def test_rules_agree_with_recorded_avals_on_representative_program(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program("rep")
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            w = static.data("w", [8, 3], "float32")
            ids = static.data("ids", [4], "int64")
            emb = static.data("emb", [16, 8], "float32")
            h = ops.matmul(x, w)
            h = ops.add(h, ops.full([3], 1.0))
            s = ops.softmax(h, axis=-1)
            r = ops.sum(s, axis=1, keepdim=True)
            ops.mean(h)
            c = ops.concat([h, h], axis=1)
            t = ops.transpose(c, [1, 0])
            f = ops.reshape(t, [-1])
            e = ops.embedding(emb, ids)
            oh = ops.one_hot(ids, 5)
            cast = ops.cast(r, "int32")
            img = static.data("img", [2, 3, 8, 8], "float32")
            ker = static.data("ker", [4, 3, 3, 3], "float32")
            conv = ops.conv2d(img, ker, stride=1, padding=1)
            ops.relu(conv)
    env = _si(P).infer_program(main, check=True)
    assert tuple(env[h.var_id].shape) == (4, 3)
    assert tuple(env[c.var_id].shape) == (4, 6)
    assert tuple(env[f.var_id].shape) == (24,)
    assert tuple(env[e.var_id].shape) == (4, 8)
    assert tuple(env[oh.var_id].shape) == (4, 5)
    assert tuple(env[conv.var_id].shape) == (2, 4, 8, 8)
    assert _dt(env[cast.var_id].dtype) == "int32"


def test_control_flow_and_fallback_ops_infer(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program("cf")
        with static.program_guard(main):
            x = static.data("x", [4], "float32")
            i = ops.zeros([], "int32")
            n = ops.full([], 3, "int32")
            _, acc = static.nn.while_loop(
                lambda i, a: ops.less_than(i, n),
                lambda i, a: (i + 1, a * 2.0), [i, x])
            y = ops.roll(acc, 1)
    env = _si(P).infer_program(main, check=True)
    assert tuple(env[acc.var_id].shape) == (4,)
    assert tuple(env[y.var_id].shape) == (4,)


def test_misshaped_matmul_flagged_at_build_time(P):
    with static_mode(P) as static:
        main = static.Program("bad_mm")
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            w = static.data("w", [8, 3], "float32")
            P.ops.matmul(x, w)
    broken = copy.copy(main)
    mm = copy.copy(main.ops[0])
    x_ref = mm.flat[0]
    mm.flat = [x_ref, copy.copy(x_ref)] + list(mm.flat[2:])
    broken.ops = [mm]
    si = _si(P)
    with pytest.raises(si.ShapeInferError, match="contraction") as e:
        si.infer_program(broken)
    assert e.value.op_name == "matmul"


def test_recorded_aval_drift_detected():
    """The JAX case swaps an output's aval; the port's aval is its
    Variable's own shape, so the port's case swaps the Variable."""
    with static_mode(PORT) as static:
        main = static.Program("drift")
        with static.program_guard(main):
            x = static.data("x", [2, 3], "float32")
            PORT.ops.exp(x)
    broken = copy.copy(main)
    op = copy.copy(main.ops[0])
    bad = static.Variable([7, 7], "float32", program=main)
    bad.var_id = op.out_ids[0]
    op.out_vars = [bad]
    broken.ops = [op]
    si = _si(PORT)
    with pytest.raises(si.ShapeInferError, match="records shape"):
        si.infer_program(broken)


def _half(P):
    return torch.float16 if P is PORT else __import__(
        "jax.numpy", fromlist=["float16"]).float16


def test_amp_boundary_mismatch_flagged(P):
    with static_mode(P) as static:
        main = static.Program("ampb")
        with static.program_guard(main):
            a = static.data("a", [4, 4], "float16")
            b = static.data("b", [4, 4], "float32")
            out = P.ops.add(a, b)
    main.amp_level = "O1"
    main.amp_dtype = _half(P)
    si = _si(P)
    with pytest.raises(si.ShapeInferError, match="AMP boundary") as e:
        si.infer_program(main)
    assert "add" in str(e.value)
    env = si.infer_program(main, amp_check=False)
    assert tuple(env[out.var_id].shape) == (4, 4)


def test_amp_white_op_casts_cleanly(P):
    with static_mode(P) as static:
        main = static.Program("ampw")
        with static.program_guard(main):
            x = static.data("x", [4, 8], "float32")
            w = static.data("w", [8, 3], "float32")
            out = P.ops.matmul(x, w)
    main.amp_level = "O1"
    main.amp_dtype = _half(P)
    env = _si(P).infer_program(main)
    assert _dt(env[out.var_id].dtype) == "float16"


def test_memory_estimator_on_mlp(P):
    with static_mode(P) as static:
        main = static.Program("mlp")
        with static.program_guard(main):
            x = static.data("x", [32, 64], "float32")
            w1 = static.data("w1", [64, 128], "float32")
            w2 = static.data("w2", [128, 10], "float32")
            h = P.ops.relu(P.ops.matmul(x, w1))
            out = P.ops.softmax(P.ops.matmul(h, w2))
    main._jit_fetch_vars = [out]
    est = _si(P).analyze_memory(main)
    feed = (32 * 64 + 64 * 128 + 128 * 10) * 4
    assert est["feed_bytes"] == feed
    assert est["param_bytes"] == 0
    assert len(est["timeline"]) == len(main.ops)
    assert est["activation_peak_bytes"] >= 32 * 128 * 4
    assert est["peak_bytes"] <= feed + 4 * (32 * 128 * 2 + 32 * 10 * 2)
    assert est["peak_bytes"] == feed + est["activation_peak_bytes"]


def test_memory_estimate_matches_jax_on_bert():
    ests = {}
    for P in (JAX, PORT):
        main, _ = _model_program(P, "bert")
        ests[P.name] = _si(P).analyze_memory(main)
    # param bytes differ: JAX's static copies share scope entries (the
    # tie, test_torch_static_bert.py); feeds and activations agree
    for k in ("feed_bytes", "activation_peak_bytes"):
        assert ests["port"][k] == ests["jax"][k], k


def test_executor_publishes_memory_estimate_under_flag():
    from paddle_tpu_torch.core import flags, monitor
    with static_mode(PORT) as static:
        main = static.Program("est")
        with static.program_guard(main):
            x = static.data("x", [4, 4], "float32")
            out = PORT.ops.relu(x)
    exe = static.Executor()
    monitor.reset("executor/estimated_peak_bytes")
    flags.set_flags({"FLAGS_log_memory_estimate": True})
    try:
        got = exe.run(main, feed={"x": np.ones((4, 4), "float32")},
                      fetch_list=[out])[0]
    finally:
        flags.set_flags({"FLAGS_log_memory_estimate": False})
    np.testing.assert_allclose(got, np.ones((4, 4)))
    assert monitor.stat_get("executor/estimated_peak_bytes") > 0


def test_host_reading_ops_raise_by_name():
    with static_mode(PORT) as static:
        main = static.Program("h")
        with static.program_guard(main):
            x = static.data("x", [4], "float32")
            with pytest.raises(TypeError, match="nonzero reads values"):
                PORT.ops.nonzero(x)
            si = _si(PORT)
            with pytest.raises(si.ShapeInferError, match="masked_select"):
                PORT.ops.masked_select(x, x > 0)


def _model_program(P, kind, seq=16):
    from importlib import import_module
    base = P.paddle.__name__ + ".text.models."
    with static_mode(P) as static:
        main = static.Program(kind)
        with static.program_guard(main):
            ids = static.data("ids", [2, seq], "int64")
            if kind == "bert":
                m = import_module(base + "bert")
                cfg = m.BertConfig.tiny()
                cfg.hidden_dropout_prob = 0.0
                cfg.attention_probs_dropout_prob = 0.0
                lab = static.data("labels", [2, seq], "int64")
                out = m.Bert(cfg)(ids, masked_lm_labels=lab)
            else:
                m = import_module(base + "gpt")
                cfg = m.GPTConfig(vocab_size=256, hidden_size=64,
                                  num_layers=2, num_heads=2,
                                  intermediate_size=128, max_seq_len=128)
                out = m.GPT(cfg)(ids)
    main._jit_fetch_vars = [out]
    return main, out


# the JAX package's CPU gate runs its CE composite where the port runs
# the fused op's plain version
_SAME_OP = {"ce_head_fallback": "fused_ce_op"}


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_port_rules_give_jax_shapes_on_model_programs(kind):
    got = {}
    for P in (JAX, PORT):
        main, _ = _model_program(P, kind)
        env = _si(P).infer_program(main, check=True)
        got[P.name] = [(_SAME_OP.get(op.name, op.name),
                        [(tuple(int(s) for s in env[o].shape),
                          _dt(np.dtype(env[o].dtype).name
                              if P is JAX else env[o].dtype))
                         for o in op.out_ids]) for op in main.ops]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("kind", ["bert", "gpt"])
def test_port_rules_agree_with_meta_on_model_programs(kind):
    """Every op of the program with a rule: the rule's avals equal the raw
    function's on meta tensors (where the raw function can run there)."""
    import torch.utils._pytree as pytree
    from paddle_tpu_torch.ops._dispatch import raw_scope
    from paddle_tpu_torch.static.program import _Ref
    main, _ = _model_program(PORT, kind)
    si = _si(PORT)
    env = si.infer_program(main)
    checked = 0
    for op in main.ops:
        rule = SHAPE_INFER_REGISTRY.get(op.name)
        if rule is None or op.name in ("flash_sdpa", "fused_ce_op"):
            continue
        vals = [env[x.var_id] if isinstance(x, _Ref) else x
                for x in op.flat]
        metas = [si._meta(v) for v in vals]
        with raw_scope():
            out = op.fn(*metas[:op.n_args],
                        **pytree.tree_unflatten(metas[op.n_args:],
                                                op.kw_tree))
        outs = out if isinstance(out, (tuple, list)) else [out]
        for o, oid in zip(outs, op.out_ids):
            assert tuple(o.shape) == tuple(env[oid].shape), op.name
            assert o.dtype == env[oid].dtype, op.name
        checked += 1
    assert checked >= 10
