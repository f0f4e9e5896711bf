"""Shape-keyed block-size autotuning for the CUDA kernels
(paddle_tpu/ops/pallas/autotune.py).

The first call at a new (kernel, shape bucket, dtype, device name) key
times the candidate block configurations on the card and records the
winner. Resolution order at a call site, as in the JAX module:

1. an explicit flag override (``FLAGS_serve_block_size``): the caller
   checks it first, and it always wins, never measured;
2. an in-process table hit;
3. a disk cache hit (``PADDLE_TPU_CUDA_AUTOTUNE_CACHE=<path>.json``), so a
   job pays the measurement once per shape family, not once per process;
4. measure and record: only where the kernel runs on a CUDA device, or
   under ``FLAGS_pallas_autotune_force`` (the tests, with a fake
   ``measure``). A candidate whose measurement raises is skipped and
   counted under ``autotune.failed_candidate.<kernel>``;
5. otherwise the caller's heuristic default.

The key carries the device's name (``torch.cuda.get_device_name``, or
``cpu``), so a table measured on an H100 is never read on another card:
the JAX module keys on the backend, "tpu" or "cpu". Shape keys are
bucketed (next power of two), so s = 1000 and s = 1024 share an entry.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

from ...core import flags as _flags
from ...core import monitor
from ...device import resolve_device

__all__ = ["bucket", "lookup", "time_thunk", "clear", "table_snapshot",
           "cache_path"]

_LOCK = threading.RLock()
_TABLE = {}          # key tuple -> params tuple (measured winners only)
_LOADED_PATH = None  # disk cache file already merged into _TABLE


def bucket(n: int) -> int:
    """Next power of two >= n (shape-family key, not the exact length)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def cache_path():
    return os.environ.get("PADDLE_TPU_CUDA_AUTOTUNE_CACHE") or None


def _device_name(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _key(kernel, shape_key, dtype, device):
    return (str(kernel), tuple(int(x) for x in shape_key),
            _dtype_name(dtype), _device_name(device))


def _key_str(key):
    kernel, shape_key, dtype, device = key
    return "|".join([kernel, ",".join(str(x) for x in shape_key), dtype,
                     device])


def _load_disk_locked():
    """Merge the disk cache into the in-process table (once per path)."""
    global _LOADED_PATH
    path = cache_path()
    if path is None or path == _LOADED_PATH:
        return
    _LOADED_PATH = path
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return  # a missing or corrupt cache is a missed optimization
    for ks, entry in data.get("entries", {}).items():
        parts = ks.split("|")
        if len(parts) != 4:
            continue
        kernel, shape_s, dtype, device = parts
        shape_key = tuple(int(x) for x in shape_s.split(",") if x)
        _TABLE.setdefault((kernel, shape_key, dtype, device),
                          tuple(entry["params"]))


def _save_disk_locked(key, params, seconds, timings):
    path = cache_path()
    if path is None:
        return
    # one writer at a time on a sidecar lock: the read-modify-write below
    # would otherwise drop another process's entry
    import fcntl
    with open(f"{path}.lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {"version": 1, "entries": {}}
        data.setdefault("entries", {})[_key_str(key)] = {
            "params": list(params), "seconds": seconds,
            "candidates": [[list(p), t] for p, t in timings]}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: readers see old or new


def _should_measure(device):
    if not _flags.flag("FLAGS_pallas_autotune"):
        return False
    if _flags.flag("FLAGS_pallas_autotune_force"):
        return True  # tests: exercise the measuring path off the card
    # plain versions run on the CPU: their times say nothing of the card
    return device.type == "cuda"


def lookup(kernel, shape_key, dtype, candidates, measure, default,
           device=None):
    """Resolve block params for one kernel call.

    kernel: short name ("paged_decode_attention"); shape_key: a tuple of
    bucketed ints describing the shape family; dtype: the torch dtype;
    candidates: param tuples worth trying (the caller guarantees each is
    legal for the real, unbucketed shape); measure: params -> seconds
    (an exception disqualifies the candidate); default: the params
    returned when measuring is off; device: where the kernel runs (None:
    the current device).
    """
    device = resolve_device(device)
    key = _key(kernel, shape_key, dtype, device)
    with _LOCK:
        _load_disk_locked()
        hit = _TABLE.get(key)
    if hit is not None:
        # the disk cache may hold a candidate this call cannot use (other
        # divisibility inside one bucket): the default then
        if hit in [tuple(c) for c in candidates]:
            return hit
        return default
    if not _should_measure(device) or measure is None \
            or len(candidates) <= 1:
        return default
    best, best_t, timings = None, None, []
    for cand in candidates:
        try:
            t = measure(tuple(cand))
        except Exception:  # noqa: BLE001 — counted; the others compete
            monitor.stat_add(f"autotune.failed_candidate.{kernel}")
            continue
        timings.append((tuple(cand), t))
        if t is not None and (best_t is None or t < best_t):
            best, best_t = tuple(cand), float(t)
    if best is None:
        return default
    with _LOCK:
        _TABLE[key] = best
        _save_disk_locked(key, best, best_t, timings)
    monitor.stat_add(f"autotune.measured.{kernel}")
    return best


def time_thunk(thunk, repeats=5, inner=10):
    """Seconds per call of ``thunk``: one untimed call (first launch,
    build), then the best of ``repeats`` runs of ``inner`` calls. When the
    thunk returns a CUDA tensor, each run is timed with CUDA events behind
    a ~1 ms device sleep, so the host's launch time is hidden; otherwise
    with the host clock."""
    out = thunk()
    cuda = isinstance(out, torch.Tensor) and out.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(out.device)
    best = None
    for _ in range(repeats):
        if cuda:
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                thunk()
            e.record()
            e.synchronize()
            dt = a.elapsed_time(e) / 1e3 / inner
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                thunk()
            dt = (time.perf_counter() - t0) / inner
        best = dt if best is None or dt < best else best
    return best


def clear():
    """Drop the in-process table (tests)."""
    global _LOADED_PATH
    with _LOCK:
        _TABLE.clear()
        _LOADED_PATH = None


def table_snapshot():
    with _LOCK:
        return dict(_TABLE)
