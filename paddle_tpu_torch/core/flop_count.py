"""FLOP and byte counting for ``paddle.flops`` and
``profiler.cost_analysis``.

The JAX package reads XLA's cost analysis of the compiled forward. torch
has none, so the port counts the aten ops a call runs
(``torch.utils._python_dispatch.TorchDispatchMode``), by these rules:

- matrix products count 2 x their multiply-adds exactly: ``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot``,
  ``convolution`` (and its backward) and torch's SDPA ops. These are
  ``matmul_flops``; an ``addmm``'s bias add is one FLOP an output element
  besides.
- A hand-written kernel's wrapper (decorated with ``kernel_flops``) counts
  its own formula, and nothing of what runs inside it: a ctypes launch is
  invisible to the dispatcher, and on the CPU the plain version runs in
  its place. So the count does not depend on the device. Attention counts
  4·bh·sq·sk·d forward (QKᵀ and PV, masked pairs included, as the
  composite's products) and 6 FLOPs a score for the softmax, bias and
  scale; the CE head 2·n·H·V for the logits and (3 + bias)·n·V + 2·n for
  the log-sum-exp and the label term.
- XLA counts transcendental functions apart from its FLOPs; so do these
  rules: ``exp``, ``log``, ``tanh``, ``sigmoid``, ``erf``, ``sqrt``,
  ``rsqrt``, ``sin``, ``cos`` ... count 0.
- Fused ops count what XLA's composite of them counts: ``gelu`` 4 an
  element (7 for the tanh form), ``softmax`` / ``log_softmax`` 4, layer
  norm 6, inference batch norm 4.
- Reductions count one FLOP an input element; ``mean`` adds one an output
  element.
- Views, copies, casts, gathers, concatenations and creation ops count 0.
- Every other op counts one FLOP an output element.
- What runs under ``uncounted()`` counts nothing: a repair one device
  alone needs (the CPU's gelu at +inf) would otherwise make the count
  depend on the device.

Bytes accessed: each op but the views and metadata ops reads each input
tensor once and writes each output once (a kernel: its inputs and
outputs).
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["FlopCounter", "kernel_flops", "uncounted"]

_active = None          # the FlopCounter counting now, if any


def _mm(args, out):
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1], 0


def _addmm(args, out):
    _, a, b = args[:3]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1], out.numel()


def _bmm(args, out):
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], 0


def _baddbmm(args, out):
    _, a, b = args[:3]
    return (2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2],
            out.numel())


def _mv(args, out):
    a = args[0]
    return 2 * a.shape[0] * a.shape[1], 0


def _addmv(args, out):
    a = args[1]
    return 2 * a.shape[0] * a.shape[1], out.numel()


def _dot(args, out):
    return 2 * args[0].numel(), 0


def _conv(args, out):
    from torch.utils.flop_counter import conv_flop_count
    x, w, bias = args[:3]
    transposed = bool(args[6]) if len(args) > 6 else False
    mm = conv_flop_count(list(x.shape), list(w.shape), list(out.shape),
                         transposed)
    return mm, out.numel() if bias is not None else 0


def _conv_bwd(args, out):
    from torch.utils.flop_counter import conv_backward_flop
    return conv_backward_flop(*args, out_val=out), 0


def _sdpa(args, out):
    from torch.utils.flop_counter import sdpa_flop_count
    q, k, v = args[:3]
    return sdpa_flop_count(q.shape, k.shape, v.shape), 0


_aten = torch.ops.aten

_MATMUL = {
    _aten.mm: _mm, _aten.addmm: _addmm, _aten.bmm: _bmm,
    _aten.baddbmm: _baddbmm, _aten.mv: _mv, _aten.addmv: _addmv,
    _aten.dot: _dot, _aten.convolution: _conv,
    _aten.convolution_backward: _conv_bwd,
    _aten._scaled_dot_product_flash_attention: _sdpa,
    _aten._scaled_dot_product_efficient_attention: _sdpa,
}

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "erf", "erfc", "erfinv", "sqrt", "rsqrt", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "lgamma",
    "digamma"}

# per output element: the ops XLA sees as a composite
_FUSED = {"_softmax": 4, "_log_softmax": 4, "native_layer_norm": 6,
          "_native_batch_norm_legit_no_training": 4,
          "native_batch_norm": 4, "hardtanh": 2, "clamp": 2,
          "logsumexp": 3}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "argmax", "argmin", "var", "std", "var_mean", "std_mean",
               "norm", "linalg_vector_norm", "any", "all", "cumsum",
               "cumprod"}

# no FLOPs, no bytes: views and metadata (names without the in-place
# variant's trailing underscore, as _op_flops looks them up)
_VIEWS = {n.rstrip("_") for n in {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "transpose", "t",
    "permute", "expand", "expand_as", "squeeze", "unsqueeze", "slice",
    "select", "as_strided", "split", "split_with_sizes", "chunk",
    "unbind", "alias", "detach", "narrow", "diagonal", "unfold",
    "view_as_real", "view_as_complex", "movedim", "lift_fresh",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_has_compatible_shallow_copy_type", "set_",
    "resize_", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided"}}

# no FLOPs; their bytes move
_MOVES = {n.rstrip("_") for n in {
    "clone", "copy_", "_to_copy", "to", "contiguous", "cat", "stack",
    "index_select", "gather", "embedding", "index", "zeros", "ones",
    "full", "full_like", "zeros_like", "ones_like", "fill_", "fill",
    "zero_", "arange", "new_zeros", "new_ones", "new_full",
    "scalar_tensor", "lift_fresh_copy", "slice_scatter", "select_scatter",
    "repeat", "flip", "roll", "constant_pad_nd", "_copy_from",
    "_copy_from_and_resize", "masked_select", "nonzero", "index_put_",
    "index_put", "scatter", "scatter_", "tril", "triu", "one_hot",
    "linspace", "randperm", "rand", "randn", "uniform_", "normal_",
    "bernoulli_", "random_", "bernoulli", "native_dropout",
    "embedding_dense_backward", "split_copy", "unbind_copy",
    "transpose_copy", "permute_copy", "view_copy", "t_copy",
    "expand_copy", "_unsafe_index", "_pin_memory", "pin_memory",
    "_assert_async", "_assert_tensor_metadata", "detach_copy"}}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _bytes(inputs, outputs):
    seen, total = set(), 0
    for t in _tensors(inputs) + _tensors(outputs):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _op_flops(func, args, kwargs, out):
    """(matmul FLOPs, other FLOPs) of one aten call by the rules above."""
    packet = func.overloadpacket
    rule = _MATMUL.get(packet)
    if rule is not None:
        return rule(args, out)
    name = packet.__name__.rstrip("_")
    if name in _VIEWS or name in _MOVES or name in _TRANSCENDENTAL:
        return 0, 0
    outs = _tensors(out)
    n_out = sum(t.numel() for t in outs)
    if name in _FUSED:
        first = outs[0].numel() if outs else 0
        return 0, _FUSED[name] * first
    if name == "gelu":
        approx = kwargs.get("approximate", args[1] if len(args) > 1
                            else "none")
        return 0, (7 if approx == "tanh" else 4) * n_out
    if name in _REDUCTIONS:
        x = args[0] if args and isinstance(args[0], torch.Tensor) else None
        n_in = x.numel() if x is not None else n_out
        return 0, n_in + (n_out if name == "mean" else 0)
    return 0, n_out


class FlopCounter(TorchDispatchMode):
    """Count the FLOPs and bytes of the aten ops run inside the block.

    ``flops`` is the total, ``matmul_flops`` its matrix-product part (2 x
    the multiply-adds), ``bytes`` the bytes accessed, ``by_op`` {op name:
    FLOPs}."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.bytes = 0
        self.by_op = {}
        self._suspended = 0

    def __enter__(self):
        global _active
        if _active is not None:
            raise RuntimeError("a FlopCounter is already counting")
        _active = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _active
        _active = None
        return super().__exit__(*exc)

    def add(self, name, mm, other, nbytes):
        self.matmul_flops += int(mm)
        self.flops += int(mm) + int(other)
        self.bytes += int(nbytes)
        self.by_op[name] = self.by_op.get(name, 0) + int(mm) + int(other)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        mm, other = _op_flops(func, args, kwargs, out)
        name = func.overloadpacket.__name__
        nbytes = 0 if name.rstrip("_") in _VIEWS \
            else _bytes((args, kwargs), out)
        if mm or other or nbytes:
            self.add(name, mm, other, nbytes)
        return out


def kernel_flops(formula):
    """Decorate a kernel wrapper: under a ``FlopCounter`` its call counts
    ``formula(*args, **kwargs)`` -> (matmul FLOPs, other FLOPs) and its
    tensors' bytes, and nothing of the ops that run inside it. Without a
    counter the call costs one module-level read."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = _active
            if c is None:
                return fn(*args, **kwargs)
            mm, other = formula(*args, **kwargs)
            c._suspended += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                c._suspended -= 1
            c.add(fn.__name__, mm, other, _bytes((args, kwargs), out))
            return out
        return wrapper
    return deco


@contextlib.contextmanager
def uncounted():
    """Run the block without counting it (no cost without a counter)."""
    c = _active
    if c is None:
        yield
        return
    c._suspended += 1
    try:
        yield
    finally:
        c._suspended -= 1
