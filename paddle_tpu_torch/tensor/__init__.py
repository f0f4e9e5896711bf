"""paddle.tensor, the tensor-function namespace
(paddle_tpu/tensor/__init__.py).

Reference python/paddle/tensor/ (creation.py, manipulation.py, math.py,
linalg.py, logic.py, random.py, search.py, stat.py, attribute.py). The
functions live in the port's ``ops``; this namespace re-exports them in
the reference's module layout, so ``from paddle.tensor.creation import
full`` works: ``random``, ``search``, ``stat`` and ``attribute`` are
synthesized from the names the JAX package lists, and ``creation``,
``linalg``, ``logic``, ``manipulation``, ``math`` and ``reduction`` are
the op modules themselves.
"""
from __future__ import annotations

import sys
import types

from ..ops import *  # noqa: F401,F403
from ..ops import (creation, linalg, logic, manipulation,  # noqa: F401
                   math, reduction)
from .. import ops as _ops


def _synth(name, symbols):
    import importlib
    import importlib.machinery
    m = types.ModuleType(f"{__name__}.{name}")
    m.__spec__ = importlib.machinery.ModuleSpec(m.__name__, None)
    root = importlib.import_module(__name__.rsplit(".", 1)[0])
    for s in symbols:
        fn = getattr(_ops, s, None)
        if fn is None:  # some families live on the paddle root only
            try:
                fn = getattr(root, s)
            except AttributeError:
                fn = None
        if fn is not None:
            setattr(m, s, fn)
    sys.modules[m.__name__] = m
    return m


# reference tensor/random.py
random = _synth("random", [
    "bernoulli", "multinomial", "normal", "rand", "randint", "randn",
    "randperm", "uniform", "poisson", "standard_gamma", "binomial",
    "log_normal", "truncated_normal", "exponential_",
])

# reference tensor/search.py
search = _synth("search", [
    "argmax", "argmin", "argsort", "searchsorted", "bucketize", "index_sample",
    "index_select", "masked_select", "nonzero", "sort", "topk", "where",
    "kthvalue", "mode",
])

# reference tensor/stat.py
stat = _synth("stat", [
    "mean", "median", "nanmedian", "quantile", "nanquantile", "std", "var",
    "numel",
])

# reference tensor/attribute.py
attribute = _synth("attribute", [
    "imag", "real", "is_complex", "is_floating_point", "is_integer",
    "rank", "shape",
])

# register the real ops modules under this package path too, so
# `import paddle_tpu_torch.tensor.math` works like the reference's layout
for _name, _mod in (("creation", creation), ("linalg", linalg),
                    ("logic", logic), ("manipulation", manipulation),
                    ("math", math), ("reduction", reduction)):
    sys.modules[f"{__name__}.{_name}"] = _mod
