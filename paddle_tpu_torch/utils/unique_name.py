"""Unique name generator (paddle_tpu/utils/unique_name.py, copied as it
is): reference python/paddle/fluid/unique_name.py, the
UniqueNameGenerator LayerHelper names parameters and variables with.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict

_lock = threading.Lock()
_counters = defaultdict(int)


def generate(key: str) -> str:
    with _lock:
        n = _counters[key]
        _counters[key] += 1
    return f"{key}_{n}"


@contextlib.contextmanager
def guard(prefix: str = ""):
    global _counters
    with _lock:
        saved = _counters
        _counters = defaultdict(int)
    try:
        yield
    finally:
        with _lock:
            _counters = saved


def switch():
    global _counters
    with _lock:
        _counters = defaultdict(int)
