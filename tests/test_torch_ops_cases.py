"""The op sweep of the port's parity tests: one case per op of
paddle_tpu_torch's OP_REGISTRY, run through the JAX op of the same name
(paddle_tpu.ops.OP_REGISTRY) and the port's on the same seeded numpy
inputs, forward and, where the op is differentiable, the gradients of
sum(out * c) for a seeded cotangent c.

A case names the op, its arguments (numpy arrays become tensors in each
package; ``Raw`` values pass as they are) and its keywords, the argument
positions to differentiate, the tolerance and the dtype its float
arrays become (f32 unless the case says otherwise). This module holds no
test of its own: the other ``test_torch_ops_*.py`` files each run a
group, and ``test_torch_ops_registry.py`` holds the groups to the whole
registry.
"""
import numpy as np
import paddle_tpu as jp
import paddle_tpu.nn.functional  # noqa: F401  registers the head ops
import paddle_tpu_torch as tp


from paddle_tpu_torch.testing.op_cases import (  # noqa: F401,E402
    Case, Raw, bools, f32, ints, pos, rs)


def _tensor(pkg, a, grad, dtype=""):
    if isinstance(a, Raw):
        return a.value
    if isinstance(a, np.ndarray):
        if dtype and a.dtype.kind == "f":
            return pkg.to_tensor(a, dtype=dtype, stop_gradient=not grad)
        return pkg.to_tensor(a, stop_gradient=not grad)
    return a


def _np(x):
    if x is None:
        return None
    if hasattr(x, "numpy"):
        x = x.numpy()
    return np.asarray(x)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _kind(a):
    return "f" if a.dtype.kind in "fc" or a.dtype.name == "bfloat16" \
        else a.dtype.kind


def _compare(got, want, rtol, atol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs " \
                                    f"{want.shape}"
    assert _kind(got) == _kind(want), f"{what}: dtype {got.dtype} vs " \
                                      f"{want.dtype}"
    if _kind(want) != "f":
        # integer and bool outputs hold the dtype itself; a float output
        # holds its kind (JAX runs with x64: D in core/tensor.py)
        assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} vs " \
                                        f"{want.dtype}"
    if _kind(want) == "f":
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def run(case):
    """Forward (and gradients) of ``case`` in both packages, compared."""
    outs, grads = {}, {}
    for pkg in (jp, tp):
        args = [_tensor(pkg, a, i in case.grad, case.dtype)
                for i, a in enumerate(case.args)]
        kw = {k: _tensor(pkg, v, False, case.dtype)
              for k, v in case.kw.items()}
        out = pkg.ops.OP_REGISTRY[case.name](*args, **kw)
        outs[pkg] = _flat(out)
        if case.grad:
            loss = None
            for i, o in enumerate(outs[pkg]):
                if _kind(_np(o)) != "f":
                    continue
                c = rs(100 + i).uniform(-1, 1, o.shape).astype(np.float32)
                term = (o * pkg.to_tensor(c)).sum()
                loss = term if loss is None else loss + term
            loss.backward()
            grads[pkg] = [args[i].grad for i in case.grad]
    assert len(outs[jp]) == len(outs[tp]), str(case)
    for k, (w, g) in enumerate(zip(outs[jp], outs[tp])):
        _compare(g, w, case.rtol, case.atol, f"{case} output {k}")
    for i, w, g in zip(case.grad, grads.get(jp, ()), grads.get(tp, ())):
        _compare(g, w, case.rtol, case.atol, f"{case} d/d arg {i}")


X = f32(3, 4)
Y = f32(3, 4, seed=1)
# the special values of a float, each op's edge cases (ROADMAP Queue 3 C5)
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 0.5, 2.0],
                   np.float32)
# floats past an integer range: a cast saturates (C4)
SATURATE = np.array([300.0, -300.0, np.nan, np.inf, -np.inf, -1.7, 1e10,
                     127.9, -128.9], np.float32)
INT32 = ints(3, 4, lo=-4, hi=6, dtype=np.int32)
P = pos(3, 4)
V = f32(5)


def _unary(names, x=X, **kw):
    return [Case(n, (x,), grad=(0,), **kw) for n in names]


MATH = [
    *[Case(n, (X, Y), grad=(0, 1)) for n in
      ("add", "subtract", "multiply", "maximum", "minimum")],
    Case("divide", (X, P), grad=(0, 1)),
    Case("add", (X, f32(4, seed=2)), grad=(0, 1), id="broadcast"),
    Case("add", (X, Raw(2.5)), grad=(0,), id="scalar"),
    Case("subtract", (Raw(1.0), X), grad=(1,), id="rscalar"),
    Case("divide", (Raw(2.0), P), grad=(1,), id="rscalar"),
    Case("floor_divide", (P * 7, P)), Case("remainder", (X * 5, P)),
    Case("mod", (X * 5, P)), Case("pow", (P, Y), grad=(0, 1)),
    Case("pow", (P, Raw(2.0)), grad=(0,), id="scalar"),
    Case("fmax", (X, Y)), Case("fmin", (X, Y)),
    Case("scale", (X,), {"scale": 2.0, "bias": 0.5}, grad=(0,)),
    Case("scale", (X,), {"scale": 2.0, "bias": 0.5,
                         "bias_after_scale": False}, grad=(0,), id="before"),
    *_unary(("neg", "abs", "exp", "expm1", "sin", "cos", "tan", "sinh",
             "cosh", "tanh", "asinh", "atan", "erf", "square", "frac",
             "rad2deg", "deg2rad", "trunc", "floor", "ceil", "round",
             "sign")),
    *_unary(("log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
             "lgamma"), x=P),
    Case("digamma", (P,), grad=(0,), rtol=1e-4, atol=1e-5),
    *_unary(("asin", "acos", "atanh", "erfinv"), x=X * 0.9, rtol=1e-4,
            atol=1e-5),
    Case("acosh", (P + 1.0,), grad=(0,)),
    Case("atan2", (X, Y), grad=(0, 1)),
    Case("clip", (X,), {"min": -0.5, "max": 0.5}, grad=(0,)),
    Case("lerp", (X, Y, Raw(0.3)), grad=(0, 1)),
    Case("cumsum", (X,), {"axis": 1}, grad=(0,)),
    Case("cumsum", (X,), grad=(0,), id="flat"),
    Case("cumprod", (X,), {"dim": 0}, grad=(0,)),
    Case("logcumsumexp", (X,), {"axis": 1}, grad=(0,)),
    Case("logaddexp", (X, Y), grad=(0, 1)),
    Case("logit", (P / 3.0,), {"eps": 1e-3}, grad=(0,)),
    Case("multiply_no_nan", (X, np.where(Y > 0, Y, 0).astype(np.float32))),
    Case("stanh", (X,), grad=(0,)),
    Case("cast", (X * 5, Raw("int32"))),
    Case("cast", (X, Raw("float64")), grad=(0,), id="f64"),
    Case("increment", (X,), {"value": 2.0}, grad=(0,)),
    Case("kron", (f32(2, 2), f32(2, 3, seed=1)), grad=(0, 1)),
    Case("diff", (X,), {"axis": 1}, grad=(0,)),
    Case("angle", (X,)), Case("conj", (X,)), Case("real", (X,)),
    Case("imag", (X,)),
    Case("gcd", (ints(6, lo=1, hi=30), ints(6, lo=1, hi=30, seed=1))),
    Case("lcm", (ints(6, lo=1, hi=30), ints(6, lo=1, hi=30, seed=1))),
    Case("heaviside", (np.array([-1.0, 0.0, 2.0], np.float32),
                       np.array([0.5, 0.5, 0.5], np.float32))),
    Case("nan_to_num", (np.array([np.nan, 1.0, -2.0], np.float32),)),
    Case("assign", (X,), grad=(0,)),
    *[Case(n, (SPECIAL,), id="special") for n in
      ("neg", "abs", "sign", "exp", "expm1", "log", "log2", "log10",
       "log1p", "sqrt", "rsqrt", "square", "reciprocal", "sin", "cos",
       "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
       "acosh", "atanh", "erf", "erfinv", "floor", "ceil", "round",
       "trunc", "digamma", "lgamma", "stanh", "frac", "rad2deg", "deg2rad",
       "angle", "real", "imag", "logit", "nan_to_num")],
    *[Case("cast", (SATURATE, Raw(d)), id=f"saturate_{d}") for d in
      ("int8", "uint8", "int16", "int32", "int64")],
    Case("cumsum", (INT32,), {"axis": 1}, id="int32"),
    Case("cumsum", (INT32,), id="int32_flat"),
    Case("cumprod", (INT32,), {"dim": 0}, id="int32"),
    Case("heaviside", (ints(6, lo=-2, hi=3), ints(6, seed=1)), id="int"),
    Case("multiply_no_nan", (INT32, ints(3, 4, lo=-1, hi=2, seed=1,
                                         dtype=np.int32)), id="int"),
    Case("logaddexp", (INT32, ints(3, 4, seed=1)), id="int"),
    Case("addmm", (f32(4), X, f32(4, 4, seed=3)), grad=(0, 1, 2)),
    Case("addmm", (f32(5), f32(2, 3, 4), f32(4, 5, seed=3)), grad=(0, 1, 2),
         id="3d"),
    Case("addmm", (f32(3, 5), f32(3, 4), f32(4, 5, seed=3)),
         {"beta": 0.5, "alpha": 2.0}, grad=(0, 1, 2), id="scaled"),
]

LINALG = [
    Case("matmul", (X, f32(4, 5, seed=1)), grad=(0, 1)),
    Case("matmul", (f32(2, 3, 4), f32(2, 5, 4, seed=1)),
         {"transpose_y": True}, grad=(0, 1), id="batched_ty"),
    Case("matmul", (f32(4, 3), f32(4, 5, seed=1)), {"transpose_x": True},
         grad=(0, 1), id="tx"),
    Case("matmul", (V, f32(5, 3, seed=1)), grad=(0, 1), id="vec"),
    Case("dot", (X, Y), grad=(0, 1)),
    Case("bmm", (f32(2, 3, 4), f32(2, 4, 5, seed=1)), grad=(0, 1)),
    Case("mv", (X, f32(4, seed=1)), grad=(0, 1)),
    Case("outer", (V, f32(3, seed=1)), grad=(0, 1)),
    Case("inner", (X, Y), grad=(0, 1)),
    Case("cross", (f32(4, 3), f32(4, 3, seed=1)), grad=(0, 1)),
    Case("norm", (X,), grad=(0,)),
    Case("norm", (X,), {"axis": 1}, grad=(0,), id="axis"),
    Case("norm", (X,), {"p": 1, "axis": 0}, grad=(0,), id="p1"),
    Case("norm", (X,), {"p": float("inf"), "axis": 1}, grad=(0,),
         id="inf"),
    Case("p_norm", (X,), {"porder": 3.0, "axis": 1}, grad=(0,)),
    Case("dist", (X, Y), grad=(0, 1)),
    Case("dist", (X, Y), {"p": float("inf")}, id="inf"),
    Case("multi_dot", (f32(2, 3), f32(3, 4, seed=1), f32(4, 2, seed=2)),
         grad=(0, 1, 2)),
    Case("einsum", (Raw("ij,kj->ik"), X, Y), grad=(1, 2)),
]

X3 = f32(2, 3, 4)
TIES = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 0, 1, 1, 0]], np.float32)

MANIPULATION = [
    Case("reshape", (X, Raw([4, 3])), grad=(0,)),
    Case("transpose", (X3, Raw([2, 0, 1])), grad=(0,)),
    Case("transpose", (X3,), grad=(0,), id="reverse"),
    Case("moveaxis", (X3, Raw(0), Raw(2)), grad=(0,)),
    Case("swapaxes", (X3, Raw(0), Raw(2)), grad=(0,)),
    Case("t", (X,), grad=(0,)),
    Case("concat", (X, Y), {"axis": 1}, grad=(0, 1)),
    Case("stack", (X, Y), {"axis": 1}, grad=(0, 1)),
    Case("split_op", (f32(3, 6), Raw(3), Raw(1)), grad=(0,)),
    Case("split_op", (f32(3, 6), Raw([1, 2, 3]), Raw(1)), grad=(0,),
         id="sizes"),
    Case("split", (f32(3, 6), Raw([2, -1])), {"axis": 1}, grad=(0,)),
    Case("chunk", (f32(6, 2), Raw(3)), grad=(0,)),
    Case("unbind_op", (X, Raw(1)), grad=(0,)),
    Case("unbind", (X,), {"axis": 0}, grad=(0,)),
    Case("unstack", (X,), {"axis": 1}, grad=(0,)),
    Case("squeeze", (f32(3, 1, 4),), grad=(0,)),
    Case("squeeze", (f32(1, 3, 1),), {"axis": [0, 1]}, grad=(0,), id="list"),
    Case("unsqueeze", (X, Raw([0, 3])), grad=(0,)),
    Case("flatten", (X3,), {"start_axis": 1}, grad=(0,)),
    Case("expand", (f32(1, 4), Raw([3, -1])), grad=(0,)),
    Case("expand_as", (f32(1, 4), X), grad=(0,)),
    Case("broadcast_to", (f32(4), Raw([3, 4])), grad=(0,)),
    Case("tile", (X, Raw([2, 1])), grad=(0,)),
    Case("flip", (X,), {"axis": [0, 1]}, grad=(0,)),
    Case("reverse", (X,), {"axis": 1}, grad=(0,)),
    Case("roll", (X, Raw(2)), {"axis": 1}, grad=(0,)),
    Case("roll", (X, Raw(5)), grad=(0,), id="flat"),
    Case("rot90", (X,), grad=(0,)),
    Case("gather", (X, ints(5, hi=3)), grad=(0,)),
    Case("gather", (X, ints(2, 2, hi=4)), {"axis": 1}, grad=(0,), id="nd"),
    Case("gather_nd", (X3, ints(5, 2, hi=2)), grad=(0,)),
    Case("index_select", (X, ints(6, hi=4)), {"axis": 1}, grad=(0,)),
    Case("index_sample", (X, ints(3, 2, hi=4)), grad=(0,)),
    Case("take_along_axis", (X, ints(3, 2, hi=4), Raw(1)), grad=(0,)),
    Case("put_along_axis", (X, ints(3, 1, hi=4), f32(3, 1, seed=5),
                            Raw(1)), grad=(0, 2)),
    Case("scatter", (X, np.array([2, 0], np.int64), f32(2, 4, seed=5)),
         grad=(0, 2)),
    Case("scatter", (X, np.array([2, 0], np.int64), f32(2, 4, seed=5)),
         {"overwrite": False}, grad=(0, 2), id="add"),
    Case("scatter_nd_add", (X, ints(5, 1, hi=3), f32(5, 4, seed=5)),
         grad=(0, 2)),
    Case("where", (bools(3, 4), X, Y), grad=(1, 2)),
    Case("masked_select", (X, bools(3, 4)), grad=(0,)),
    Case("masked_fill", (X, bools(3, 4), Raw(0.5)), grad=(0,)),
    Case("pad", (X, Raw([1, 2, 0, 1])), grad=(0,)),
    Case("pad", (f32(1, 2, 3, 4), Raw([1, 2, 2, 1])), {"mode": "reflect"},
         grad=(0,), id="reflect"),
    Case("pad", (f32(1, 2, 3, 4), Raw([1, 2, 2, 1])),
         {"mode": "replicate"}, grad=(0,), id="replicate"),
    Case("pad", (f32(1, 2, 3, 4), Raw([1, 2, 2, 1])),
         {"mode": "circular"}, grad=(0,), id="circular"),
    Case("pad2d", (f32(1, 2, 3, 4), Raw([1, 0, 2, 1]))),
    Case("pad3d", (f32(1, 2, 2, 3, 4), Raw([1, 0, 1, 1, 0, 2]))),
    Case("topk_op", (X, Raw(2), Raw(1), Raw(True)), grad=(0,)),
    Case("topk", (X, Raw(2)), {"largest": False}, grad=(0,)),
    # ties: lower index first, as lax.top_k (C2)
    Case("topk", (TIES, Raw(3)), id="ties"),
    Case("topk", (TIES, Raw(3)), {"largest": False}, id="ties_smallest"),
    Case("topk_op", (TIES.T.copy(), Raw(2), Raw(0), Raw(True)), id="ties"),
    Case("sort", (X,), {"axis": 1, "descending": True}, grad=(0,)),
    Case("argsort", (X,), {"axis": 0}),
    Case("tril", (X,), {"diagonal": 1}, grad=(0,)),
    Case("triu", (X,), grad=(0,)),
    Case("diagonal", (X3,), {"offset": 1, "axis1": 1, "axis2": 2},
         grad=(0,)),
    Case("repeat_interleave", (X, Raw(2)), {"axis": 1}, grad=(0,)),
    Case("as_strided_slice", (X3, Raw([1, 2]), Raw([0, 1]), Raw([3, 4]),
                              Raw([1, 2])), grad=(0,)),
    Case("slice", (X3, Raw([0, 2]), Raw([1, 0]), Raw([2, 3])), grad=(0,)),
    Case("strided_slice", (X3, Raw([2]), Raw([0]), Raw([4]), Raw([2])),
         grad=(0,)),
    Case("getitem", (X3,), {"idx": Raw((slice(None), 1))}, grad=(0,)),
    # negative steps (C1)
    Case("getitem", (X3,), {"idx": Raw(slice(None, None, -1))}, grad=(0,),
         id="reverse"),
    Case("getitem", (X3,), {"idx": Raw((slice(None), slice(None, None, -2)))},
         grad=(0,), id="step_minus_2"),
    Case("getitem", (X3,), {"idx": Raw((Ellipsis, slice(3, 0, -2)))},
         grad=(0,), id="ellipsis"),
    Case("getitem", (X3,), {"idx": Raw((1, None, slice(-1, -5, -1), 2))},
         grad=(0,), id="mixed"),
    Case("setitem", (X, f32(4, seed=7)), {"idx": Raw(1)}, grad=(0, 1)),
    Case("setitem", (X, f32(3, 4, seed=7)),
         {"idx": Raw(slice(None, None, -1))}, grad=(0, 1), id="reverse"),
    Case("setitem", (X, f32(3, 2, seed=7)),
         {"idx": Raw((slice(None), slice(None, None, -2)))}, grad=(0, 1),
         id="step_minus_2"),
    Case("set_value", (X, f32(4, seed=7)), {"item": Raw(2)}, grad=(0,)),
    Case("one_hot", (ints(5, hi=4), Raw(4))),
    Case("tensordot", (X3, f32(4, 3, 2, seed=1)),
         {"axes": Raw([[1, 2], [1, 0]])}, grad=(0, 1)),
    Case("searchsorted", (np.array([0.1, 0.5, 0.9], np.float32), X)),
    Case("bincount", (ints(10, hi=5),)),
    Case("bincount", (ints(10, hi=5), f32(10, seed=3)), id="weights"),
    Case("as_real", (np.array([1 + 2j, 3 - 1j], np.complex64),)),
    Case("as_complex", (f32(3, 2),)),
    Case("crop", (X3, Raw([1, 2, 2]), Raw([1, 0, 1])), grad=(0,)),
    Case("space_to_depth", (f32(1, 2, 4, 4), Raw(2)), grad=(0,)),
    Case("shuffle_channel", (f32(1, 4, 2, 2), Raw(2)), grad=(0,)),
    Case("temporal_shift", (f32(4, 4, 2, 2), Raw(2)), grad=(0,)),
    Case("shard_index", (ints(8, hi=20), Raw(20), Raw(4), Raw(1))),
    Case("gather_tree", (ints(4, 2, 3, hi=9),
                         ints(4, 2, 3, hi=3, seed=1))),
    Case("pad_constant_like", (f32(4, 5), X), grad=(1,)),
]

REDUCTION = [
    *[Case(n, (X,), grad=(0,)) for n in
      ("sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
       "std", "var", "nansum", "nanmean")],
    *[Case(n, (X,), {"axis": 1, "keepdim": True}, grad=(0,), id="axis") for n
      in ("sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
          "std", "var", "nansum", "nanmean")],
    Case("sum", (X,), {"axis": [0, 1]}, grad=(0,), id="axes"),
    Case("sum", (ints(3, 4),), {"dtype": "float32"}, id="dtype"),
    # integer inputs (C3): the float mean, int32 kept
    Case("mean", (np.array([3, 4], np.int64),), id="int"),
    Case("mean", (INT32,), {"axis": 1}, id="int32"),
    *[Case(n, (INT32,), {"axis": 0}, id="int") for n in
      ("std", "var", "nanmean", "median")],
    Case("sum", (INT32,), {"axis": 1}, id="int32"),
    Case("prod", (INT32,), {"axis": 0}, id="int32"),
    Case("max", (INT32,), {"axis": 1}, id="int32"),
    Case("std", (X,), {"axis": 0, "unbiased": False}, grad=(0,), id="biased"),
    Case("argmax", (X,)), Case("argmax", (X,), {"axis": 1}, id="axis"),
    Case("argmin", (X,), {"axis": 0, "keepdim": True}),
    Case("all", (bools(3, 4),)), Case("any", (bools(3, 4),), {"axis": 1}),
    Case("median", (X,), {"axis": 1}, grad=(0,)),
    Case("median", (X,), grad=(0,), id="all"),
    Case("quantile", (X, Raw(0.3)), {"axis": 1}, grad=(0,)),
    Case("count_nonzero", (np.where(X > 0, X, 0).astype(np.float32),),
         {"axis": 1}),
    Case("mode", (ints(3, 7, hi=3).astype(np.float32),)),
    Case("kthvalue", (X, Raw(2)), {"axis": 1}, grad=(0,)),
]

LOGIC = [
    *[Case(n, (X, Y)) for n in
      ("equal", "not_equal", "greater_than", "greater_equal", "less_than",
       "less_equal")],
    Case("equal", (ints(6, hi=3), Raw(1)), id="scalar"),
    *[Case(n, (bools(3, 4), bools(3, 4, seed=1))) for n in
      ("logical_and", "logical_or", "logical_xor")],
    Case("logical_not", (bools(3, 4),)),
    *[Case(n, (ints(6, hi=16), ints(6, hi=16, seed=1))) for n in
      ("bitwise_and", "bitwise_or", "bitwise_xor")],
    Case("bitwise_not", (ints(6, hi=16),)),
    Case("isnan", (np.array([np.nan, 1.0, np.inf], np.float32),)),
    Case("isinf", (np.array([np.nan, 1.0, -np.inf], np.float32),)),
    Case("isfinite", (np.array([np.nan, 1.0, np.inf], np.float32),)),
    Case("isclose", (X, X + 1e-7)),
    Case("allclose", (X, X + 1e-7)),
    Case("allclose", (X, Y), id="far"),
    Case("is_empty", (X,)),
]

XA = f32(3, 6, seed=3) * 3

ACTIVATION = [
    *_unary(("relu", "relu6", "sigmoid", "hardswish", "tanhshrink", "silu",
             "swish", "mish", "softsign", "log_sigmoid", "selu", "celu",
             "elu", "gelu", "hardtanh", "hardshrink", "softshrink",
             "thresholded_relu"), x=XA),
    Case("gelu", (XA,), {"approximate": True}, grad=(0,), id="tanh"),
    Case("leaky_relu", (XA,), {"negative_slope": 0.2}, grad=(0,)),
    Case("prelu", (XA, f32(6, seed=4)), grad=(0, 1)),
    Case("hardsigmoid", (XA,), grad=(0,)),
    Case("softplus", (XA * 10,), {"beta": 2.0, "threshold": 5.0},
         grad=(0,)),
    Case("softmax", (XA,), {"axis": 0}, grad=(0,)),
    Case("log_softmax", (XA,), grad=(0,)),
    Case("maxout", (f32(2, 6, 3),), {"groups": 2}, grad=(0,)),
    Case("glu", (XA,), {"axis": 1}, grad=(0,)),
    Case("normalize", (XA,), {"axis": 1}, grad=(0,)),
    Case("normalize", (XA,), {"p": 1, "axis": 0}, grad=(0,), id="p1"),
    *[Case(n, (INT32,), id="int") for n in
      ("relu", "relu6", "hardshrink", "thresholded_relu", "softmax",
       "log_softmax", "elu", "celu", "leaky_relu", "log_sigmoid", "mish",
       "normalize")],
]

NCHW = f32(2, 4, 3, 3, seed=5)

NORM = [
    Case("layer_norm", (f32(2, 3, 8), f32(8, seed=1), f32(8, seed=2)),
         {"epsilon": 1e-5}, grad=(0, 1, 2)),
    Case("layer_norm", (f32(2, 3, 8), f32(3, 8, seed=1), f32(3, 8, seed=2)),
         {"begin_norm_axis": 1}, grad=(0, 1, 2), id="two_axes"),
    Case("batch_norm", (NCHW, f32(4, seed=1), pos(4, seed=2),
                        f32(4, seed=3), f32(4, seed=4)),
         {"training": True}, grad=(0, 3, 4), rtol=1e-4, atol=1e-5),
    Case("batch_norm", (NCHW, f32(4, seed=1), pos(4, seed=2)),
         grad=(0,), id="eval"),
    Case("instance_norm", (NCHW, f32(4, seed=1), f32(4, seed=2)),
         grad=(0, 1, 2), rtol=1e-4, atol=1e-5),
    Case("group_norm", (NCHW, Raw(2), f32(4, seed=1), f32(4, seed=2)),
         grad=(0, 2, 3), rtol=1e-4, atol=1e-5),
    Case("rms_norm", (f32(3, 8), f32(8, seed=1)), grad=(0, 1)),
    Case("embedding", (f32(10, 4), ints(2, 5, hi=10)), grad=(0,)),
    Case("embedding", (f32(10, 4), ints(2, 5, hi=10)), {"padding_idx": 2},
         grad=(0,), id="padding"),
    Case("local_response_norm", (NCHW,), {"size": 3}, grad=(0,)),
    Case("lrn", (NCHW,), {"n": 3}),
    Case("data_norm", (X, Raw(10.0), f32(4, seed=1), pos(4, seed=2) * 5),
         grad=(0,)),
    Case("l2_normalize", (X,), {"axis": 1}, grad=(0,)),
]

LOGITS = f32(6, 5, seed=8) * 3
LABELS = np.array([0, 4, -100, 2, 1, 3], np.int64)
PROB = pos(6, 5) / pos(6, 5).sum(1, keepdims=True)
BIN = (rs(9).rand(6, 5) > 0.5).astype(np.float32)

LOSS = [
    Case("softmax_with_cross_entropy", (LOGITS, LABELS[:, None]), grad=(0,)),
    Case("softmax_with_cross_entropy", (LOGITS, PROB),
         {"soft_label": True}, grad=(0,), id="soft"),
    Case("cross_entropy", (LOGITS, LABELS), grad=(0,)),
    Case("cross_entropy", (LOGITS, LABELS), {"weight": pos(5, seed=3)},
         grad=(0,), id="weight"),
    Case("cross_entropy", (LOGITS, LABELS), {"reduction": "none",
                                             "label_smoothing": 0.1},
         grad=(0,), id="smooth"),
    Case("cross_entropy", (LOGITS, PROB), {"soft_label": True,
                                           "reduction": "sum"},
         grad=(0,), id="soft"),
    Case("nll_loss", (LOGITS, LABELS), grad=(0,)),
    Case("mse_loss", (X, Y), grad=(0, 1)),
    Case("l1_loss", (X, Y), {"reduction": "sum"}, grad=(0, 1)),
    Case("smooth_l1_loss", (X * 3, Y), grad=(0,)),
    Case("huber_loss", (X * 3, Y), grad=(0,)),
    Case("binary_cross_entropy", (PROB, BIN), grad=(0,)),
    Case("binary_cross_entropy_with_logits", (LOGITS, BIN),
         {"pos_weight": pos(5, seed=4)}, grad=(0,)),
    Case("sigmoid_cross_entropy_with_logits", (LOGITS, BIN), grad=(0,)),
    Case("bce_loss", (PROB, BIN), grad=(0,)),
    Case("kl_div", (np.log(PROB), PROB[::-1].copy()), grad=(0,)),
    Case("kl_div", (np.log(PROB), PROB[::-1].copy()),
         {"reduction": "batchmean"}, grad=(0,), id="batchmean"),
    Case("kldiv_loss", (np.log(PROB), PROB[::-1].copy()), grad=(0,)),
    Case("margin_ranking_loss", (X, Y, np.sign(f32(3, 4, seed=9))),
         {"margin": 0.1}, grad=(0, 1)),
    Case("hinge_embedding_loss", (X, np.where(Y > 0, 1.0, -1.0).astype(
        np.float32)), grad=(0,)),
    Case("cosine_similarity", (X, Y), grad=(0, 1)),
    Case("label_smooth", (BIN,), grad=(0,)),
    Case("square_error_cost", (X, Y), grad=(0, 1)),
    Case("log_loss", (PROB, BIN), grad=(0,)),
    Case("triplet_margin_loss", (X, Y, f32(3, 4, seed=5)), grad=(0, 1, 2)),
    Case("bpr_loss", (LOGITS, np.array([[1], [0], [4], [2], [3], [1]])),
         grad=(0,)),
    Case("hinge_loss", (LOGITS, BIN), grad=(0,)),
    Case("rank_loss", (BIN[:, :1], LOGITS[:, :1], LOGITS[:, 1:2]),
         grad=(1, 2)),
    Case("modified_huber_loss", (LOGITS, BIN), grad=(0,)),
    Case("teacher_student_sigmoid_loss", (LOGITS, BIN - 0.5), grad=(0,)),
    Case("npair_loss", (X, Y, np.array([0, 1, 0], np.int64)), grad=(0, 1)),
    Case("sigmoid_focal_loss", (LOGITS, BIN), grad=(0,)),
]

# the loss head and attention ops of nn/functional; the kernels' side of
# the JAX package runs in interpret mode (the caller sets the flags)
Q = f32(2, 2, 8, 16, seed=11)
K = f32(2, 2, 8, 16, seed=12)
VV = f32(2, 2, 8, 16, seed=13)
H2 = f32(16, 16, seed=14)
W2 = f32(40, 16, seed=15) * 0.5
B2 = f32(40, seed=16) * 0.1
Y2 = np.array([3, -100, 7, 39, 0, 12, -100, 5, 21, 2, 8, 8, -100, 33, 1,
               17], np.int64)

HEAD = [
    Case("sdpa", (Q, K, VV, Raw(None), Raw(0.25), Raw(True)), grad=(0, 1, 2)),
    Case("sdpa", (Q, K, VV, (rs(3).rand(2, 1, 1, 8) > 0.3).astype(
        np.float32) * -1e9, Raw(0.25), Raw(False)), grad=(0, 1, 2),
         id="mask"),
    Case("flash_sdpa", (Q, K, VV, Raw(None), Raw(0.25), Raw(True)),
         grad=(0, 1, 2), rtol=1e-4, atol=1e-5),
    Case("fused_ce_op", (H2, W2, B2, Y2, Raw(-100)), grad=(0, 1, 2),
         rtol=1e-4, atol=1e-5),
    Case("ce_head_fallback", (H2, W2, B2, Y2, Raw(-100)), grad=(0, 1, 2)),
]

# the recurrent scans of nn/layer/rnn.py: b 3, t 5, in 4, H 6, rows of
# lengths 5, 3 and 1 (a masked row keeps and emits its state)
RX = f32(3, 5, 4, seed=20)
RH = f32(3, 6, seed=21) * 0.5
RC = f32(3, 6, seed=22) * 0.5
RMASK = np.arange(5)[None, :] < np.array([5, 3, 1])[:, None]


def _rnn_weights(gates, seed):
    return (f32(gates * 6, 4, seed=seed) * 0.4,
            f32(gates * 6, 6, seed=seed + 1) * 0.4,
            f32(gates * 6, seed=seed + 2) * 0.4,
            f32(gates * 6, seed=seed + 3) * 0.4)


RNN = [
    Case("rnn_scan_tanh", (RX, RH, *_rnn_weights(1, 30), RMASK),
         grad=(0, 1, 2, 3, 4, 5)),
    Case("lstm_scan", (RX, RH, RC, *_rnn_weights(4, 40), RMASK),
         grad=(0, 1, 2, 3, 4, 5, 6)),
    Case("gru_scan", (RX, RH, *_rnn_weights(3, 50), RMASK),
         grad=(0, 1, 2, 3, 4, 5)),
]

# ops/conv.py: every op, forward and gradients, with a case per trouble
# spot of the port (ops/conv.py's docstring): SAME pads at stride 2 on odd
# and even sizes (asymmetric on even), 4-element (lo, hi) pads, groups,
# depthwise, dilation, NHWC with HWIO weights, the ceil-mode windows of
# padding only (-inf for max, 0 / 0 for an exclusive average), the
# average divisors, the integral image of a non-divisible adaptive
# average, max-pool ties after a ReLU (whole windows of zeros, ResNet's
# overlapping 3x3 / s2), and interpolate as jax.image.resize (antialiased
# downsampling, Keys cubic, half-pixel nearest). f32 rtol / atol 1e-5;
# bf16 (the port's and XLA's CPU convs accumulate in f32 and round once,
# in different orders, and reduce a gradient over hundreds of bf16 terms):
# rtol / atol 2^-5, a few bf16 ulps (the transposed conv's bias gradient
# differs by two), and atol 2^-4 where a bf16 sum feeds a second op (the
# integral image, a resize's second axis)
CX = f32(2, 4, 9, 9, seed=40)
CX8 = f32(2, 4, 8, 8, seed=41)
CW = f32(6, 4, 3, 3, seed=42) * 0.3
CB = f32(6, seed=43)
RELU = np.maximum(f32(2, 3, 9, 9, seed=44), 0).astype(np.float32)
P5 = f32(1, 2, 5, 5, seed=45)
TW = f32(4, 3, 3, 3, seed=46) * 0.3           # transposed: [in, out, k, k]
BF = dict(dtype="bfloat16", rtol=2 ** -5, atol=2 ** -5)
BF_SUM = dict(dtype="bfloat16", rtol=2 ** -5, atol=2 ** -4)
_C = dict(rtol=1e-5, atol=1e-5)


def _unpool_indices(n, c, oh, ow, k, seed):
    r = rs(seed)
    dy = r.randint(0, k, (n, c, oh, ow))
    dx = r.randint(0, k, (n, c, oh, ow))
    oy = np.arange(oh)[:, None] * k + dy
    ox = np.arange(ow)[None, :] * k + dx
    return (oy * (ow * k) + ox).astype(np.int32)


CONV = [
    Case("conv2d", (CX, CW, CB), {"padding": 1}, grad=(0, 1, 2), **_C),
    # forward only: JAX 0.9's bf16 conv2d cannot be differentiated (its f32
    # preferred element type meets bf16 weights in the transpose rule);
    # the port's bf16 gradients: test_torch_ops_conv.py
    Case("conv2d", (CX, CW, CB), {"padding": 1}, id="bf16", **BF),
    Case("conv2d", (CX, CW, CB), {"stride": 2, "padding": "SAME"},
         grad=(0, 1), id="same_s2_odd", **_C),
    Case("conv2d", (CX8, CW, CB), {"stride": 2, "padding": "same"},
         grad=(0, 1), id="same_s2_even", **_C),
    Case("conv2d", (CX, CW), {"padding": [1, 2, 0, 1], "stride": 2},
         grad=(0, 1), id="pads4", **_C),
    Case("conv2d", (CX, CW), {"padding": "VALID", "dilation": 2},
         grad=(0, 1), id="dilation", **_C),
    Case("conv2d", (CX, CW, CB), {"padding": "SAME", "dilation": 2,
                                  "stride": 2}, grad=(0, 1),
         id="same_dilated", **_C),
    Case("conv2d", (CX, f32(6, 2, 3, 3, seed=47) * 0.3, CB),
         {"padding": 1, "groups": 2}, grad=(0, 1, 2), id="groups", **_C),
    Case("conv2d", (CX, f32(8, 1, 3, 3, seed=48) * 0.3),
         {"padding": 1, "groups": 4, "stride": 2}, grad=(0, 1),
         id="depthwise", **_C),
    Case("conv2d", (f32(2, 9, 9, 4, seed=49), f32(3, 3, 4, 6, seed=50) * 0.3,
                    CB), {"padding": 1, "data_format": "NHWC"},
         grad=(0, 1, 2), id="nhwc", **_C),
    Case("conv1d", (f32(2, 4, 11, seed=51), f32(5, 4, 3, seed=52) * 0.3,
                    f32(5, seed=53)), {"padding": 1}, grad=(0, 1, 2), **_C),
    Case("conv1d", (f32(2, 11, 4, seed=51), f32(3, 4, 5, seed=52) * 0.3),
         {"stride": 2, "padding": "SAME", "data_format": "NLC"},
         grad=(0, 1), id="nlc_same", **_C),
    Case("conv3d", (f32(1, 3, 5, 6, 7, seed=54), f32(4, 3, 3, 3, 3, seed=55)
                    * 0.3, f32(4, seed=56)), {"padding": 1, "stride": 2},
         grad=(0, 1, 2), **_C),
    Case("conv3d", (f32(1, 3, 5, 6, 7, seed=54),
                    f32(4, 3, 2, 3, 2, seed=55) * 0.3),
         {"padding": "SAME", "stride": 2}, grad=(0, 1), id="same", **_C),
    Case("conv1d_transpose", (f32(2, 4, 7, seed=57),
                              f32(4, 3, 3, seed=58) * 0.3, f32(3, seed=59)),
         {"stride": 2, "padding": 1, "output_padding": 1}, grad=(0, 1, 2),
         **_C),
    Case("conv2d_transpose", (f32(2, 4, 5, 5, seed=60), TW, f32(3, seed=61)),
         {"stride": 2, "padding": 1, "output_padding": 1}, grad=(0, 1, 2),
         **_C),
    Case("conv2d_transpose", (f32(2, 4, 5, 5, seed=60), TW, f32(3, seed=61)),
         {"stride": 2, "padding": 1, "output_padding": 1}, grad=(0, 1, 2),
         id="bf16", **BF),
    Case("conv2d_transpose", (f32(2, 4, 5, 5, seed=60),
                              f32(4, 2, 3, 3, seed=62) * 0.3),
         {"stride": 2, "groups": 2, "dilation": 2}, grad=(0, 1),
         id="groups_dilated", **_C),
    Case("conv2d_transpose", (f32(2, 4, 5, 5, seed=60), TW),
         {"stride": 2, "padding": [1, 0, 0, 2], "output_padding": 1},
         grad=(0, 1), id="pads4", **_C),
    Case("conv2d_transpose", (f32(2, 4, 5, 5, seed=60), TW),
         {"stride": 3, "padding": 0, "output_padding": 2}, grad=(0, 1),
         id="opad_past_pad", **_C),
    Case("conv3d_transpose", (f32(1, 4, 3, 4, 3, seed=63),
                              f32(4, 2, 3, 3, 3, seed=64) * 0.3,
                              f32(2, seed=65)),
         {"stride": 2, "padding": 1}, grad=(0, 1, 2), **_C),
    Case("max_pool2d", (RELU,), {"kernel_size": 3, "stride": 2,
                                 "padding": 1}, grad=(0,), id="relu_ties"),
    Case("max_pool2d", (RELU,), {"kernel_size": 3, "stride": 2,
                                 "padding": 1}, grad=(0,),
         id="relu_ties_bf16", **BF),
    Case("max_pool2d", (CX,), {"kernel_size": 2}, grad=(0,)),
    Case("max_pool2d", (P5,), {"kernel_size": 2, "stride": 2, "padding": 1,
                               "ceil_mode": True}, grad=(0,),
         id="ceil_padding_window"),
    Case("max_pool2d", (CX,), {"kernel_size": 3, "stride": 2,
                               "padding": [0, 2, 1, 1]}, grad=(0,),
         id="pads4"),
    Case("max_pool2d", (f32(2, 9, 9, 4, seed=66),),
         {"kernel_size": 3, "stride": 2, "padding": 1, "data_format": "NHWC"},
         grad=(0,), id="nhwc"),
    Case("max_pool2d", (ints(2, 3, 6, 6, lo=-9, hi=9),),
         {"kernel_size": 2, "padding": 1}, id="int"),
    Case("avg_pool2d", (CX,), {"kernel_size": 3, "stride": 2, "padding": 1},
         grad=(0,), id="exclusive"),
    Case("avg_pool2d", (CX,), {"kernel_size": 3, "stride": 2, "padding": 1},
         grad=(0,), id="exclusive_bf16", **BF),
    Case("avg_pool2d", (CX,), {"kernel_size": 3, "stride": 2, "padding": 1,
                               "exclusive": False}, grad=(0,),
         id="inclusive"),
    Case("avg_pool2d", (P5,), {"kernel_size": 2, "stride": 2, "padding": 1,
                               "ceil_mode": True}, grad=(0,),
         id="ceil_padding_window_nan"),
    Case("avg_pool2d", (CX,), {"kernel_size": 2, "stride": 2,
                               "ceil_mode": True, "exclusive": False},
         grad=(0,), id="ceil_inclusive"),
    Case("avg_pool2d", (CX,), {"kernel_size": 3, "stride": 2, "padding": 1,
                               "ceil_mode": True}, grad=(0,),
         id="ceil_exclusive_overhang"),
    Case("avg_pool2d", (CX,), {"kernel_size": 3, "padding": [2, 0, 1, 2]},
         grad=(0,), id="pads4"),
    Case("avg_pool2d", (f32(2, 9, 9, 4, seed=67),),
         {"kernel_size": 2, "padding": 1, "data_format": "NHWC"}, grad=(0,),
         id="nhwc"),
    Case("max_pool1d", (f32(2, 3, 11, seed=68),), {"kernel_size": 3,
                                                   "stride": 2, "padding": 1},
         grad=(0,)),
    Case("max_pool1d", (f32(2, 3, 11, seed=68),), {"kernel_size": 2,
                                                   "stride": 2,
                                                   "ceil_mode": True},
         grad=(0,), id="ceil"),
    Case("max_pool3d", (f32(1, 2, 5, 6, 7, seed=69),),
         {"kernel_size": 3, "stride": 2, "padding": 1}, grad=(0,)),
    Case("max_pool3d", (f32(1, 2, 5, 6, 7, seed=69),),
         {"kernel_size": 2, "ceil_mode": True}, grad=(0,), id="ceil"),
    Case("max_pool3d", (f32(1, 2, 5, 6, 8, seed=69),),
         {"kernel_size": 3, "stride": 2, "padding": "SAME"}, grad=(0,),
         id="same"),
    Case("avg_pool3d", (f32(1, 2, 5, 6, 7, seed=70),),
         {"kernel_size": 3, "stride": 2, "padding": 1}, grad=(0,)),
    Case("avg_pool3d", (f32(1, 2, 5, 6, 7, seed=70),),
         {"kernel_size": 2, "ceil_mode": True, "exclusive": False},
         grad=(0,), id="ceil_inclusive"),
    Case("avg_pool3d", (f32(1, 2, 5, 6, 8, seed=70),),
         {"kernel_size": 3, "stride": 2, "padding": "SAME"}, grad=(0,),
         id="same_not_exclusive"),
    Case("adaptive_avg_pool2d", (CX8,), {"output_size": 4}, grad=(0,),
         id="divisible"),
    Case("adaptive_avg_pool2d", (f32(2, 8, 7, 7, seed=71),),
         {"output_size": 1}, grad=(0,), id="resnet_7_to_1"),
    Case("adaptive_avg_pool2d", (CX,), {"output_size": [4, 5]}, grad=(0,),
         id="integral_image", **_C),
    Case("adaptive_avg_pool2d", (CX,), {"output_size": [4, 5]}, grad=(0,),
         id="integral_image_bf16", **BF_SUM),
    Case("adaptive_max_pool2d", (CX8,), {"output_size": [2, 4]}, grad=(0,)),
    Case("adaptive_avg_pool3d", (f32(1, 2, 4, 6, 6, seed=72),),
         {"output_size": 2}, grad=(0,)),
    Case("adaptive_max_pool3d", (f32(1, 2, 4, 6, 6, seed=72),),
         {"output_size": [2, 3, 3]}, grad=(0,)),
    Case("max_pool2d_with_index", (CX,), {"kernel_size": 3, "stride": 2,
                                          "padding": 1}, grad=(0,)),
    Case("max_pool2d_with_index", (RELU,), {"kernel_size": 2}, grad=(0,),
         id="ties"),
    Case("max_unpool2d", (f32(2, 3, 3, 4, seed=73),
                          _unpool_indices(2, 3, 3, 4, 2, 74)),
         {"kernel_size": 2}, grad=(0,)),
    Case("interpolate", (CX,), {"size": [13, 17], "mode": "nearest"},
         grad=(0,), id="nearest_up"),
    Case("interpolate", (CX,), {"size": [4, 6], "mode": "nearest"},
         grad=(0,), id="nearest_down"),
    Case("interpolate", (CX,), {"scale_factor": 2}, grad=(0,),
         id="nearest_scale"),
    Case("interpolate", (CX,), {"size": [13, 17], "mode": "bilinear"},
         grad=(0,), id="bilinear_up", **_C),
    Case("interpolate", (CX,), {"size": [13, 17], "mode": "bilinear"},
         grad=(0,), id="bilinear_up_bf16", **BF_SUM),
    Case("interpolate", (CX,), {"size": [4, 6], "mode": "bilinear",
                                "align_corners": True},
         grad=(0,), id="bilinear_down_antialiased", **_C),
    Case("interpolate", (CX,), {"size": [13, 4], "mode": "bicubic"},
         grad=(0,), id="bicubic_keys", **_C),
    Case("interpolate", (CX,), {"scale_factor": [0.5, 1.5], "mode": "area"},
         grad=(0,), id="area_is_linear", **_C),
    Case("pixel_shuffle", (f32(2, 8, 3, 3, seed=75), Raw(2)), grad=(0,)),
    Case("unfold", (CX, Raw(3)), {"strides": 2, "paddings": 1}, grad=(0,)),
    Case("unfold", (CX, Raw([2, 3])), {"dilations": 2}, grad=(0,),
         id="dilated"),
    Case("affine_channel", (CX, f32(4, seed=76), f32(4, seed=77)),
         grad=(0, 1, 2)),
    Case("affine_channel", (f32(2, 5, 5, 4, seed=78), f32(4, seed=76),
                            f32(4, seed=77)), {"data_format": "NHWC"},
         grad=(0, 1, 2), id="nhwc"),
    Case("row_conv", (f32(2, 6, 4, seed=79), f32(3, 4, seed=80)),
         grad=(0, 1)),
    Case("im2sequence", (f32(2, 3, 6, 6, seed=81), Raw(2)), {"stride": 2},
         grad=(0,)),
    Case("im2sequence", (f32(2, 3, 5, 5, seed=81), Raw([2, 3])),
         {"stride": 1, "padding": 1}, grad=(0,), id="padded"),
    Case("psroi_pool", (f32(1, 8, 6, 6, seed=82),
                        np.array([[0.0, 0.0, 4.0, 4.0], [1.0, 2.0, 5.0, 5.5],
                                  [2.5, 1.0, 3.0, 6.0]], np.float32)),
         {"pooled_height": 2, "pooled_width": 2}, grad=(0,), **_C),
    Case("psroi_pool", (f32(1, 12, 8, 8, seed=83),
                        np.array([[2.0, 4.0, 10.0, 14.0]], np.float32)),
         {"output_channels": 3, "spatial_scale": 0.5, "pooled_height": 2,
          "pooled_width": 2}, grad=(0,), id="scaled", **_C),
    Case("deform_conv2d", (f32(1, 4, 5, 5, seed=84),
                           f32(1, 18, 5, 5, seed=85) * 1.5, CW, CB),
         {"padding": 1}, grad=(0, 1, 2, 3), **_C),
    Case("deform_conv2d", (f32(1, 4, 5, 5, seed=84),
                           f32(1, 36, 3, 3, seed=86) * 1.5,
                           f32(6, 2, 3, 3, seed=87) * 0.3),
         {"stride": 2, "padding": 1, "deformable_groups": 2, "groups": 2,
          "mask": pos(1, 18, 3, 3, seed=88)}, grad=(0, 1, 2),
         id="v2_groups", **_C),
    Case("deformable_conv", (f32(1, 4, 5, 5, seed=84),
                             f32(1, 18, 5, 5, seed=85), None, CW),
         {"padding": 1}, grad=(0, 3), **_C),
]

# ops/op_tail.py (its deterministic ops; truncated_normal, sampling_id,
# print_op and assert_op have their own tests in test_torch_ops_tail.py)
_SEG = ints(7, lo=0, hi=4, seed=90)
_PRE_IDS = np.array([[3, 1], [4, 0], [2, 4]], np.int64)  # 4 = end: frozen
_PROBS = rs(91).dirichlet(np.ones(6), (3, 2)).astype(np.float32)
_TRELLIS_IDS = ints(5, 2, 3, lo=0, hi=9, seed=92)
_TRELLIS_PAR = ints(5, 2, 3, lo=0, hi=3, seed=93, dtype=np.int32)
OP_TAIL = [
    Case("spectral_norm", (f32(4, 6, seed=94), f32(4, seed=95),
                           f32(6, seed=96)), {"power_iters": 3},
         grad=(0,), rtol=1e-4, atol=1e-5),
    Case("spectral_norm", (f32(3, 5, 2, seed=97), f32(5, seed=98),
                           f32(6, seed=99)), {"dim": 1, "power_iters": 2},
         grad=(0,), rtol=1e-4, atol=1e-5, id="dim1"),
    Case("beam_search", (_PRE_IDS, f32(3, 2, seed=100, lo=-3, hi=0),
                         np.log(_PROBS), 2, 4), rtol=1e-6),
    Case("beam_search", (_PRE_IDS, f32(3, 2, seed=100, lo=-3, hi=0),
                         _PROBS, 2, 4), {"is_accumulated": False},
         rtol=1e-6, id="probabilities"),
    Case("beam_search", (np.array([[0, 1]]), np.zeros((1, 2), np.float32),
                         np.zeros((1, 2, 3), np.float32), 2, 5),
         id="ties"),
    Case("beam_search_decode", (_TRELLIS_IDS, _TRELLIS_PAR, 0)),
    Case("segment_sum", (f32(7, 3, seed=101), _SEG)),
    Case("segment_sum", (f32(7, seed=101), _SEG), {"num_segments": 6},
         id="empty_segments"),
    Case("segment_mean", (f32(7, 3, seed=102), _SEG)),
    Case("segment_mean", (f32(7, 3, seed=102), _SEG), {"num_segments": 6},
         id="empty_segments"),
    Case("segment_max", (f32(7, 3, seed=103), _SEG)),
    Case("segment_max", (f32(7, 3, seed=103), _SEG), {"num_segments": 6},
         id="empty_segments"),
    Case("segment_min", (f32(7, 3, seed=104), _SEG)),
    Case("segment_min", (ints(7, 2, lo=-9, hi=9, seed=105, dtype=np.int32),
                         _SEG), {"num_segments": 5}, id="int32"),
    Case("spp", (f32(2, 3, 8, 8, seed=106),), {"pyramid_height": 3}),
    Case("spp", (f32(2, 3, 8, 8, seed=106),),
         {"pyramid_height": 2, "pool_type": "avg"}, id="avg"),
    Case("dequantize_log", (np.array([-128, -3, -1, 0, 1, 5, 127],
                                     np.int8), pos(128, seed=107))),
    Case("positive_negative_pair", (f32(9, seed=108),
                                    ints(9, lo=0, hi=3, seed=109)
                                    .astype(np.float32),
                                    ints(9, lo=0, hi=3, seed=110))),
    Case("positive_negative_pair", (np.array([1.0, 1.0, 2.0, 0.5],
                                             np.float32),
                                    np.array([0.0, 1.0, 1.0, 0.0],
                                             np.float32),
                                    np.zeros(4, np.int64)), id="ties"),
]

GROUPS = {"math": MATH, "linalg": LINALG, "manipulation": MANIPULATION,
          "reduction": REDUCTION, "logic": LOGIC, "activation": ACTIVATION,
          "norm": NORM, "loss": LOSS, "head": HEAD, "rnn": RNN,
          "conv": CONV, "op_tail": OP_TAIL}

# ops whose output is random, made on the current device, on the host, or
# a list argument: each has its own test in test_torch_ops_registry.py (the
# last four in test_torch_ops_tail.py)
OWN_TESTS = {
    "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "arange", "linspace", "logspace", "eye", "empty", "empty_like", "diag",
    "diagflat", "meshgrid", "uniform", "rand", "normal", "randn", "randint",
    "randperm", "bernoulli", "poisson", "multinomial", "standard_normal",
    "gumbel_softmax", "dropout", "dropout_op", "nonzero", "unique",
    "unique_consecutive", "scatter_nd", "equal_all", "partial_concat",
    "partial_sum", "random_crop", "shuffle_batch",
    "truncated_normal", "sampling_id", "print_op", "assert_op",
    # the collective tier (tests/test_torch_distributed.py)
    "c_allreduce", "c_allgather", "c_reduce", "c_broadcast", "c_scatter",
    "c_alltoall", "c_reducescatter", "c_hierarchical_allreduce", "send_v2",
    "mp_allreduce_identity_bwd", "mp_identity_allreduce_bwd",
    "ring_attention", "ulysses_attention",
}
