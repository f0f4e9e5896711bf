"""The MultiSlot text parser (paddle_tpu/_native/__init__.py:107
``_parse_multislot_py``), the port's own copy.

A MultiSlot file has one sample a line; for each slot in order, a count
``n`` and then ``n`` values (reference MultiSlotDataFeed::ParseOneInstance).
``parse_multislot_file(path, slot_types)`` returns ``(rows, [(values,
row_splits), ...])``: per slot, the values (float32 for a ``"float"``
slot, int64 for a ``"uint64"`` one) and int64 row splits of length
rows + 1. The JAX package's C++ parser and its C ABI are ROADMAP Queue 1
item 9, slice 22; this is the pure-Python path, which the JAX package also runs
when its native library is absent.
"""
from __future__ import annotations

import numpy as np

__all__ = ["parse_multislot_file"]


def _parse_multislot_py(path, slot_types):
    per_slot_vals = [[] for _ in slot_types]
    per_slot_splits = [[0] for _ in slot_types]
    rows = 0
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            i = 0
            for s, t in enumerate(slot_types):
                n = int(toks[i])
                i += 1
                conv = float if t == "float" else int
                per_slot_vals[s].extend(conv(x) for x in toks[i:i + n])
                i += n
                per_slot_splits[s].append(len(per_slot_vals[s]))
            rows += 1
    out = []
    for s, t in enumerate(slot_types):
        dt = np.float32 if t == "float" else np.int64
        out.append((np.asarray(per_slot_vals[s], dt),
                    np.asarray(per_slot_splits[s], np.int64)))
    return rows, out


parse_multislot_file = _parse_multislot_py
