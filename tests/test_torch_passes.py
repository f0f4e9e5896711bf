"""Port parity: the Program passes (paddle_tpu_torch/static/passes.py)
against paddle_tpu/static/passes.py.

tests/test_passes2.py's cases run on both packages: literal-only chains
fold at record time (one recorded op), CSE merges a duplicate, and
``fold_constants`` collapses a hand-built constant chain; each rewritten
program's fetch equals the original's, and the port's equals JAX's.
"""
import numpy as np
import pytest

from paddle_tpu_torch.device import device_scope

from test_torch_static_cases import JAX, PKGS, PORT, static_mode


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


def _run(P, program, feed, fetch):
    return P.static.Executor().run(program, feed=feed, fetch_list=fetch)


def test_constant_folding_happens_at_trace_time(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program("fold")
        with static.program_guard(main):
            x = static.data("x", [2, 3], "float32")
            c = ops.arange(0, 6, dtype="float32")
            c = ops.reshape(c, [2, 3])
            c = ops.scale(c, 2.0)
            out = ops.add(x, c)
    assert len(main.ops) == 1, [op.name for op in main.ops]
    xv = np.ones((2, 3), "float32")
    (a,) = _run(P, main, {"x": xv}, [out])
    np.testing.assert_allclose(
        a, xv + np.arange(6, dtype="float32").reshape(2, 3) * 2, rtol=1e-6)


def test_cse_merges_duplicates(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program("cse")
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            a = ops.exp(x)
            b = ops.exp(x)
            out = ops.add(a, b)
    n_before = len(main.ops)
    deduped = P.static.passes.apply_pass(main, "cse")
    assert len(deduped.ops) == n_before - 1
    xv = np.random.RandomState(0).rand(2, 2).astype("float32")
    (r1,) = _run(P, main, {"x": xv}, [out])
    (r2,) = _run(P, deduped, {"x": xv}, [out])
    np.testing.assert_allclose(r1, r2, rtol=1e-6)


def _hand_built(P):
    """transpose -> scale of a constant, then a matmul with the data."""
    prog_mod = P.static.program
    if P is JAX:
        import jax.tree_util as jtu
        flatten = jtu.tree_flatten
        w = np.full((4, 4), 2.0, "float32")
    else:
        import torch
        import torch.utils._pytree as pytree
        flatten = pytree.tree_flatten
        w = torch.full((4, 4), 2.0)
    reg = P.ops.OP_REGISTRY
    prog = prog_mod.Program("fold")
    x = prog_mod.Variable([2, 4], "float32", name="x", is_data=True,
                          program=prog)
    prog.add_data_var(x)

    def mk(opname, flat, n_args, shape):
        leaves, tree = flatten({})
        out = prog_mod.Variable(shape, "float32", program=prog)
        prog.ops.append(prog_mod.OpNode(reg[opname].raw, opname,
                                        list(flat) + leaves, n_args, tree,
                                        [out]))
        return out

    wt = mk("transpose", [w, [1, 0]], 2, (4, 4))
    ws = mk("scale", [prog_mod._Ref(wt), 3.0], 2, (4, 4))
    out = mk("matmul", [prog_mod._Ref(x), prog_mod._Ref(ws)], 2, (2, 4))
    prog._jit_fetch_vars = [out]
    return prog, out


def test_fold_constants_on_deserialized_program(P):
    prog, out = _hand_built(P)
    folded = P.static.passes.fold_constants(prog)
    assert len(folded.ops) == 1, len(folded.ops)
    xv = np.random.RandomState(0).rand(2, 4).astype("float32")
    (a,) = _run(P, prog, {"x": xv}, [out])
    (b,) = _run(P, folded, {"x": xv}, [out])
    np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(a, xv @ (np.full((4, 4), 2.0).T * 3.0),
                               rtol=1e-5)


def test_passes_keep_jax_fetches():
    outs = {}
    for P in (JAX, PORT):
        with static_mode(P) as static:
            main = static.Program("p")
            with static.program_guard(main):
                x = static.data("x", [3, 4], "float32")
                a = P.ops.tanh(x)
                b = P.ops.tanh(x)
                c = P.ops.exp(x)                 # dead
                out = P.ops.sum(a * b, axis=1)
        main._jit_fetch_vars = [out]
        new = P.static.passes.apply_pass(
            main, ["cse", "eliminate_dead_ops", "fold_constants"])
        assert [op.name for op in new.ops] == ["tanh", "multiply", "sum"]
        assert c.var_id not in {o for op in new.ops for o in op.out_ids}
        xv = np.random.RandomState(1).rand(3, 4).astype("float32")
        outs[P.name] = _run(P, new, {"x": xv}, [out])[0]
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-6)
