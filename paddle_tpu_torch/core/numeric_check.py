"""Numeric debugging: the FLAGS_check_nan_inf sweep
(paddle_tpu/core/numeric_check.py).

Two tiers, as in the JAX package:

- eager ops: ``check_op_outputs`` runs right after each op's kernel in
  ``ops/_dispatch.defop`` and raises naming the op. A compiled step of
  the JAX package (``Model``'s jitted step) sees tracers there and skips
  the check; the port's counterpart of such a step runs inside
  ``step_scope()``, which turns the per-op check off, so the step raises
  at the same point as JAX's: its sweep.
- steps: ``sweep`` checks a tree of step outputs (loss, fetches, the new
  scope or parameters) before they are written back, naming every
  offending entry by its path, written as ``jax.tree_util.keystr``
  writes it (``['scope']['fc.w_0']``).

On the card a check reads one flag a tensor back to the host: it is a
debugging mode, and each check is a device sync.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import flags as _flags

__all__ = ["enabled", "check_op_outputs", "sweep", "step_scope"]

_local = threading.local()


def enabled() -> bool:
    return bool(_flags.flag("FLAGS_check_nan_inf"))


def op_checks_on() -> bool:
    """The op layer's check: the flag on and no step scope open."""
    return bool(_flags._REGISTRY["FLAGS_check_nan_inf"]) \
        and not getattr(_local, "step", 0)


@contextlib.contextmanager
def step_scope():
    """The body runs as one compiled step: no per-op checks."""
    _local.step = getattr(_local, "step", 0) + 1
    try:
        yield
    finally:
        _local.step -= 1


def _float_tensor(v):
    from ..static.program import Variable
    return isinstance(v, torch.Tensor) and not isinstance(v, Variable) \
        and v.is_floating_point()


def _np_dtype(t):
    return str(t.dtype).replace("torch.", "")


def _counts(t):
    return int(torch.isnan(t).sum()), int(torch.isinf(t).sum())


def check_op_outputs(op_name: str, out_val):
    """Raise if any floating output of an eager op has nan / inf."""
    outs = out_val if isinstance(out_val, (tuple, list)) else [out_val]
    for i, v in enumerate(outs):
        if not _float_tensor(v):
            continue
        if bool(torch.isfinite(v).all()):
            continue
        n_nan, n_inf = _counts(v)
        raise RuntimeError(
            f"[FLAGS_check_nan_inf] op '{op_name}' output {i} contains "
            f"{n_nan} nan / {n_inf} inf values "
            f"(shape={tuple(v.shape)}, dtype={_np_dtype(v)})")


def _flatten(tree, path=""):
    """(keystr path, leaf) pairs, named as ``jax.tree_util.keystr`` names
    them: dicts by sorted key, namedtuples by field (``.w``), other
    sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _flatten(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def sweep(tree, context: str):
    """Check every floating leaf of ``tree``; raise naming the bad ones.
    One host read for the whole tree when every leaf is finite."""
    import numpy as np
    leaves = []
    for path, v in _flatten(tree):
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            v = torch.from_numpy(v)
        if _float_tensor(v):
            leaves.append((path, v))
    if not leaves:
        return
    by_dev = {}
    for i, (_, v) in enumerate(leaves):
        by_dev.setdefault(v.device, []).append(i)
    bad_idx = []
    for dev, idx in by_dev.items():
        flags = torch.stack([~torch.isfinite(leaves[i][1]).all()
                             for i in idx]).cpu()
        bad_idx += [i for i, f in zip(idx, flags.tolist()) if f]
    if not bad_idx:
        return
    bad = []
    for i in sorted(bad_idx):
        path, v = leaves[i]
        n_nan, n_inf = _counts(v)
        bad.append(f"{path}: {n_nan} nan / {n_inf} inf "
                   f"(shape={tuple(v.shape)})")
    raise RuntimeError(
        f"[FLAGS_check_nan_inf] non-finite values after {context}:\n  " +
        "\n  ".join(bad))
