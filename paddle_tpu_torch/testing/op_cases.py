"""The op sweep's case records and seeded inputs, without JAX: the
parity tests (tests/test_torch_ops_cases.py and the long-tail groups of
``testing/long_tail_cases.py``) run each case through both packages, and
chip_smoke.py's phase 28 through the port on the card and on the host.

A case names the op, its arguments (numpy arrays become tensors; ``Raw``
values pass as they are) and its keywords, the argument positions to
differentiate, the tolerance and the dtype its float arrays become (f32
unless the case says otherwise).
"""
import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Raw:
    """An argument passed to both packages as it is."""
    value: object


@dataclasses.dataclass
class Case:
    name: str
    args: tuple
    kw: dict = dataclasses.field(default_factory=dict)
    grad: tuple = ()             # argument positions to differentiate
    rtol: float = 1e-5
    atol: float = 1e-6
    id: str = ""
    dtype: str = ""              # the float arrays' dtype ("" keeps f32)

    def __str__(self):
        return self.name + (f"-{self.id}" if self.id else "")


def rs(seed):
    return np.random.RandomState(seed)


def f32(*shape, seed=0, lo=-1.0, hi=1.0):
    return rs(seed).uniform(lo, hi, shape).astype(np.float32)


def pos(*shape, seed=0):
    return rs(seed).uniform(0.5, 2.0, shape).astype(np.float32)


def ints(*shape, seed=0, lo=0, hi=5, dtype=np.int64):
    return rs(seed).randint(lo, hi, shape).astype(dtype)


def bools(*shape, seed=0):
    return rs(seed).rand(*shape) > 0.5
