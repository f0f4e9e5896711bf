"""The port's native pieces, built with the host compiler at first use
(paddle_tpu/_native/__init__.py's counterpart).

- The MultiSlot parser (``src/multislot_parser.cc``), the C++ data-feed
  hot path of the reference (framework/data_feed.cc), compiled with g++
  into ``lib/libpaddle_tpu_native.so`` and bound through ctypes (a ctypes
  call releases the GIL, so a thread pool parses files in parallel).
  ``parse_multislot_file(path, slot_types)`` returns ``(rows, [(values,
  row_splits), ...])``: per slot, the values (float32 for a ``"float"``
  slot, int64 for a ``"uint64"`` one) and int64 row splits of length
  rows + 1. The pure-Python parser runs only where g++ is missing or the
  build fails, as in the JAX package; the counters
  ``native.multislot.cxx`` and ``native.multislot.py`` (``core/monitor``)
  count the files each one parsed.
- The C ABI (``include/paddle_tpu_capi.h``, ``src/predictor_capi.c``,
  ``src/train_capi.c``): ``build_capi()`` compiles
  ``lib/libpaddle_tpu_capi.so`` with gcc against Python.h and the shared
  libpython, the name the Go and R clients link. It embeds CPython and
  calls ``inference/capi_bridge.py`` and ``static/capi_train.py``.
  ``capi_env()`` is the environment a C host needs to find this package
  and torch from the embedded interpreter.

Each library is written to a temporary file and moved into place, so
several processes can build at once.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading

import numpy as np

from ..core import monitor

__all__ = ["native_lib", "parse_multislot_file", "build_capi",
           "capi_header", "capi_env", "embed_flags"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_DIR = os.path.join(_HERE, "lib")
_SO = os.path.join(_LIB_DIR, "libpaddle_tpu_native.so")
_SRC = os.path.join(_HERE, "src", "multislot_parser.cc")
_CAPI_SO = os.path.join(_LIB_DIR, "libpaddle_tpu_capi.so")
_CAPI_SRCS = [os.path.join(_HERE, "src", "predictor_capi.c"),
              os.path.join(_HERE, "src", "train_capi.c")]
_CAPI_HEADER = os.path.join(_HERE, "include", "paddle_tpu_capi.h")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _stale(target, sources):
    return not os.path.exists(target) or any(
        os.path.getmtime(target) < os.path.getmtime(s) for s in sources)


def _compile(cmd_head, sources, target, flags=()):
    """``cmd_head sources -o tmp flags``, then the temporary file moved to
    ``target``."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run([*cmd_head, *sources, "-o", tmp, *flags], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def native_lib():
    """The loaded parser library, building it first if needed; None when
    it cannot be built (callers fall back to Python)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if _stale(_SO, [_SRC]):
                _compile(["g++", "-O3", "-shared", "-fPIC", "-std=c++17"],
                         [_SRC], _SO)
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        lib.pt_parse_multislot_file.restype = ctypes.c_void_p
        lib.pt_parse_multislot_file.argtypes = [ctypes.c_char_p,
                                                ctypes.c_char_p]
        lib.pt_ms_rows.restype = ctypes.c_longlong
        lib.pt_ms_rows.argtypes = [ctypes.c_void_p]
        lib.pt_ms_error.restype = ctypes.c_char_p
        lib.pt_ms_error.argtypes = [ctypes.c_void_p]
        lib.pt_ms_slot_total.restype = ctypes.c_longlong
        lib.pt_ms_slot_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for fn in ("pt_ms_copy_splits", "pt_ms_copy_f32", "pt_ms_copy_i64"):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.pt_ms_free.restype = None
        lib.pt_ms_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_multislot_file(path, slot_types):
    """Parse one MultiSlot text file into per-slot (values, row_splits)
    numpy arrays. slot_types: a list of 'uint64' | 'float'."""
    lib = native_lib()
    if lib is None:
        monitor.stat_add("native.multislot.py")
        return _parse_multislot_py(path, slot_types)
    monitor.stat_add("native.multislot.cxx")
    h = lib.pt_parse_multislot_file(
        os.fsencode(path), ",".join(slot_types).encode())
    if not h:
        raise IOError(f"cannot parse {path}")
    try:
        err = lib.pt_ms_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        rows = int(lib.pt_ms_rows(h))
        out = []
        for s, t in enumerate(slot_types):
            total = int(lib.pt_ms_slot_total(h, s))
            splits = np.empty(rows + 1, np.int64)
            lib.pt_ms_copy_splits(h, s, splits.ctypes.data)
            vals = np.empty(total, np.float32 if t == "float" else np.int64)
            (lib.pt_ms_copy_f32 if t == "float" else lib.pt_ms_copy_i64)(
                h, s, vals.ctypes.data)
            out.append((vals, splits))
        return rows, out
    finally:
        lib.pt_ms_free(h)


def _parse_multislot_py(path, slot_types):
    """The pure-Python parser (reference
    MultiSlotDataFeed::ParseOneInstance semantics)."""
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


# ---- the C ABI -------------------------------------------------------------

def embed_flags():
    """gcc flags that compile against Python.h and link the shared
    libpython of this interpreter (with its directory on the rpath)."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    flags = [f"-I{sysconfig.get_paths()['include']}"]
    if libdir:
        flags += [f"-L{libdir}", f"-Wl,-rpath,{libdir}"]
    return flags + [f"-lpython{ver}", "-ldl", "-lm"]


def build_capi():
    """Compile ``lib/libpaddle_tpu_capi.so`` if it is missing or older than
    its sources. Returns its path."""
    with _lock:
        if _stale(_CAPI_SO, _CAPI_SRCS + [_CAPI_HEADER]):
            _compile(["gcc", "-O2", "-shared", "-fPIC"], _CAPI_SRCS,
                     _CAPI_SO, embed_flags())
    return _CAPI_SO


def capi_header():
    return _CAPI_HEADER


def capi_env(base=None):
    """``base`` (default ``os.environ``) with this package's root and the
    building interpreter's site-packages on ``PYTHONPATH``: an embedded
    interpreter starts from its compiled-in prefix, not from a virtual
    environment's."""
    import site
    env = dict(os.environ if base is None else base)
    root = os.path.dirname(os.path.dirname(_HERE))
    paths = [root, *site.getsitepackages()]
    if env.get("PYTHONPATH"):
        paths.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(p for p in paths if p))
    return env
