"""Port parity: the Program verifier and the pass harness
(paddle_tpu_torch/static/verifier.py, passes.py) against the JAX
package's.

tests/test_verifier.py's seeded corpus of broken Programs and its
harness cases run, letter for letter, on both packages: the autouse
``pkg`` fixture binds this module's names (``paddle``, ``ops``,
``verify_program`` ...) to one package per run, so each case must raise
the same rule naming the same op and var in both.
"""
import copy

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.static.passes as jpasses
import paddle_tpu.static.program as jprogram
import paddle_tpu.static.verifier as jverifier
import paddle_tpu_torch
import paddle_tpu_torch.static.passes as tpasses
import paddle_tpu_torch.static.program as tprogram
import paddle_tpu_torch.static.verifier as tverifier
from paddle_tpu_torch.device import device_scope

_BIND = {
    "jax": (paddle_tpu, jpasses, jprogram, jverifier),
    "port": (paddle_tpu_torch, tpasses, tprogram, tverifier),
}


@pytest.fixture(autouse=True, params=list(_BIND))
def pkg(request):
    global paddle, ops, apply_pass, register_pass, set_verify_passes, \
        _PASS_REGISTRY, _Ref, ProgramVerifyError, verify_program
    pk, passes, program, verifier = _BIND[request.param]
    paddle, ops = pk, pk.ops
    apply_pass, register_pass = passes.apply_pass, passes.register_pass
    set_verify_passes = passes.set_verify_passes
    _PASS_REGISTRY = passes._PASS_REGISTRY
    _Ref = program._Ref
    ProgramVerifyError = verifier.ProgramVerifyError
    verify_program = verifier.verify_program
    with device_scope("cpu"):
        yield request.param


def _static():
    paddle.enable_static()
    return paddle.static


def _chain_program(static):
    """data -> exp -> add(exp, data) -> sum, fetched."""
    main = static.Program("chain")
    with static.program_guard(main):
        x = static.data("x", [2, 3], "float32")
        a = ops.exp(x)
        b = ops.add(a, x)
        out = ops.sum(b)
    main._jit_fetch_vars = [out]
    return main, out


# ---------------------------------------------------------------------------
# the seeded broken-program corpus
# ---------------------------------------------------------------------------

def test_corpus_1_dangling_ref_after_dropped_producer():
    static = _static()
    try:
        main, _ = _chain_program(static)
        broken = copy.copy(main)
        broken.ops = main.ops[1:]  # a "DCE" that drops exp but keeps add
        with pytest.raises(ProgramVerifyError, match="dangling-ref") as e:
            verify_program(broken)
        assert e.value.op_name == "add"
        assert e.value.var is not None
    finally:
        paddle.disable_static()


def test_corpus_2_use_before_def_after_reorder():
    static = _static()
    try:
        main, _ = _chain_program(static)
        broken = copy.copy(main)
        broken.ops = [main.ops[1], main.ops[0], main.ops[2]]
        with pytest.raises(ProgramVerifyError, match="use-before-def") as e:
            verify_program(broken)
        assert e.value.op_name == "add"
        assert "exp" in str(e.value)  # names the too-late producer
    finally:
        paddle.disable_static()


def test_corpus_3_double_assignment():
    static = _static()
    try:
        main, _ = _chain_program(static)
        broken = copy.copy(main)
        broken.ops = [main.ops[0], main.ops[0]] + main.ops[1:]
        with pytest.raises(ProgramVerifyError,
                           match="single-assignment") as e:
            verify_program(broken)
        assert e.value.op_name == "exp"
    finally:
        paddle.disable_static()


def test_corpus_4_out_ids_desynced_from_out_vars():
    static = _static()
    try:
        main, _ = _chain_program(static)
        broken = copy.copy(main)
        bad_op = copy.copy(main.ops[0])
        bad_op.out_ids = [bad_op.out_ids[0] + 999_999]
        broken.ops = [bad_op] + main.ops[1:]
        with pytest.raises(ProgramVerifyError, match="out-ids-sync"):
            verify_program(broken)
    finally:
        paddle.disable_static()


def test_corpus_5_output_shadows_data_var():
    static = _static()
    try:
        main, _ = _chain_program(static)
        x_id = next(iter(main.data_vars.values())).var_id
        broken = copy.copy(main)
        bad_op = copy.copy(main.ops[0])
        bad_op.out_ids = [x_id]
        bad_op.out_vars = list(bad_op.out_vars)
        bad_op.out_vars[0].var_id = x_id
        broken.ops = [bad_op] + main.ops[1:]
        with pytest.raises(ProgramVerifyError, match="shadows"):
            verify_program(broken)
    finally:
        paddle.disable_static()


def test_corpus_6_fetch_root_eliminated():
    static = _static()
    try:
        main, out = _chain_program(static)
        broken = copy.copy(main)
        broken.ops = main.ops[:-1]  # drops the fetched sum
        with pytest.raises(ProgramVerifyError, match="root-liveness") as e:
            verify_program(broken)
        assert e.value.var == out.name
    finally:
        paddle.disable_static()


def test_corpus_7_state_write_target_eliminated():
    static = _static()
    try:
        main, _ = _chain_program(static)
        broken = copy.copy(main)
        broken.state_writes = {"bn_mean": 987_654_321}  # producer gone
        with pytest.raises(ProgramVerifyError, match="root-liveness") as e:
            verify_program(broken)
        assert e.value.var == "bn_mean"
    finally:
        paddle.disable_static()


def test_corpus_8_backward_loss_eliminated():
    static = _static()
    try:
        main, out = _chain_program(static)
        broken = copy.copy(main)
        broken._jit_fetch_vars = []
        broken.backward_section = (out, [])
        broken.ops = main.ops[:-1]
        with pytest.raises(ProgramVerifyError, match="root-liveness") as e:
            verify_program(broken)
        assert out.name in str(e.value)
    finally:
        paddle.disable_static()


def _while_program(static):
    main = static.Program("loop")
    with static.program_guard(main):
        x = static.data("x", [4], "float32")
        i = ops.zeros([], "int32")
        n = ops.full([], 3, "int32")
        _, acc = static.nn.while_loop(
            lambda i, a: ops.less_than(i, n),
            lambda i, a: (i + 1, a * 2.0), [i, x])
    main._jit_fetch_vars = [acc]
    return main


def test_corpus_9_subblock_dangling_inner_ref():
    static = _static()
    try:
        main = _while_program(static)
        broken = copy.copy(main)
        widx, wop = next((i, op) for i, op in enumerate(main.ops)
                         if op.name == "while_loop")
        bad_op = copy.copy(wop)
        bad_fn = copy.copy(wop.fn)
        bad_blk = copy.copy(bad_fn.body_block)
        bad_blk.ops = list(bad_blk.ops)
        inner = copy.copy(bad_blk.ops[-1])
        inner.flat = [(_corrupt_ref(r) if isinstance(r, _Ref) else r)
                      for r in inner.flat]
        bad_blk.ops[-1] = inner
        bad_fn.body_block = bad_blk
        bad_op.fn = bad_fn
        broken.ops = list(main.ops)
        broken.ops[widx] = bad_op
        with pytest.raises(ProgramVerifyError, match="sub-block") as e:
            verify_program(broken)
        assert e.value.op_name == "while_loop"
    finally:
        paddle.disable_static()


def _corrupt_ref(r):
    r2 = copy.copy(r)
    r2.var_id = r.var_id + 999_999
    return r2


def test_corpus_10_subblock_free_arity_mismatch():
    static = _static()
    try:
        main = _while_program(static)
        broken = copy.copy(main)
        widx, wop = next((i, op) for i, op in enumerate(main.ops)
                         if op.name == "while_loop")
        bad_op = copy.copy(wop)
        bad_fn = copy.copy(wop.fn)
        bad_blk = copy.copy(bad_fn.cond_block)
        bad_blk.free_ids = list(bad_blk.free_ids) + [123_456_789]
        bad_fn.cond_block = bad_blk
        bad_op.fn = bad_fn
        broken.ops = list(main.ops)
        broken.ops[widx] = bad_op
        with pytest.raises(ProgramVerifyError, match="sub-block") as e:
            verify_program(broken)
        assert e.value.op_name == "while_loop"
    finally:
        paddle.disable_static()


def test_corpus_11_subblock_undefined_output():
    static = _static()
    try:
        main = _while_program(static)
        broken = copy.copy(main)
        widx, wop = next((i, op) for i, op in enumerate(main.ops)
                         if op.name == "while_loop")
        bad_op = copy.copy(wop)
        bad_fn = copy.copy(wop.fn)
        bad_blk = copy.copy(bad_fn.body_block)
        bad_blk.out_ids = [999_999_999] * len(bad_blk.out_ids)
        bad_fn.body_block = bad_blk
        bad_op.fn = bad_fn
        broken.ops = list(main.ops)
        broken.ops[widx] = bad_op
        with pytest.raises(ProgramVerifyError, match="sub-block"):
            verify_program(broken)
    finally:
        paddle.disable_static()


# ---------------------------------------------------------------------------
# well-formed programs verify clean; passes run under the harness
# ---------------------------------------------------------------------------

def test_wellformed_programs_verify_clean():
    static = _static()
    try:
        main, _ = _chain_program(static)
        assert verify_program(main) is main
        assert verify_program(_while_program(static)) is not None
    finally:
        paddle.disable_static()


def test_every_builtin_pass_runs_under_verify_harness():
    static = _static()
    try:
        main, out = _chain_program(static)
        old = set_verify_passes(True)
        try:
            for name in ("eliminate_dead_ops",
                         "common_subexpression_elimination",
                         "fold_constants"):
                reg_name = {"common_subexpression_elimination": "cse"}.get(
                    name, name)
                assert reg_name in _PASS_REGISTRY
                result = apply_pass(main, reg_name)
                verify_program(result, pass_name=reg_name)
        finally:
            set_verify_passes(old)
        # and the fetched value still computes correctly end-to-end
        exe = static.Executor()
        pruned = apply_pass(main, ["cse", "eliminate_dead_ops"])
        xs = np.ones((2, 3), "float32")
        got = exe.run(pruned, feed={"x": xs}, fetch_list=[out])[0]
        np.testing.assert_allclose(
            got, np.sum(np.exp(xs) + xs), rtol=1e-6)
    finally:
        paddle.disable_static()


def test_harness_blames_the_breaking_pass():
    static = _static()
    try:
        main, _ = _chain_program(static)

        @register_pass("_test_broken_pass")
        def _broken(program):
            new = copy.copy(program)
            new.ops = program.ops[1:]  # drops a live producer
            return new

        old = set_verify_passes(True)
        try:
            with pytest.raises(ProgramVerifyError) as e:
                apply_pass(main, "_test_broken_pass")
            assert e.value.pass_name == "_test_broken_pass"
            assert "_test_broken_pass" in str(e.value)
        finally:
            set_verify_passes(old)
            _PASS_REGISTRY.pop("_test_broken_pass", None)
    finally:
        paddle.disable_static()


def test_analysis_pass_only_legal_at_chain_tail():
    static = _static()
    try:
        main, _ = _chain_program(static)
        dot = apply_pass(main, ["eliminate_dead_ops", "graph_viz"])
        assert isinstance(dot, str) and dot.startswith("digraph")
        with pytest.raises(TypeError, match="must come last"):
            apply_pass(main, ["graph_viz", "eliminate_dead_ops"])
    finally:
        paddle.disable_static()


def test_harness_env_flag_gates_verification(monkeypatch):
    passes_mod = paddle.static.passes
    set_verify_passes(None)
    monkeypatch.setenv("PADDLE_TPU_VERIFY_PASSES", "0")
    assert not passes_mod.verify_passes_enabled()
    monkeypatch.setenv("PADDLE_TPU_VERIFY_PASSES", "1")
    assert passes_mod.verify_passes_enabled()
