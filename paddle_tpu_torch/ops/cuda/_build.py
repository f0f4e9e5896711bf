"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``. The library lands in ``ops/cuda/.build/`` under a name that
carries the hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded; ptxas's report of each kernel's
registers and spills is kept beside it (``report``). Nothing here runs at
import: ``load(name)`` builds (if needed) and opens the library on first
call; ``start_all`` starts every build at once and returns, so a caller
can use the first library while the others compile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "build_all", "start_all", "wait", "build_seconds",
           "report", "nvcc_path", "SOURCES", "DTYPE_CODE"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / ".build"
SOURCES = ("decode_attention", "fused_ce", "fused_ce_sm90", "flash_attention",
           "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the element-type codes the entries of the flash and CE sources take
DTYPE_CODE = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}

_lock = threading.Lock()
_libs: dict = {}
_pending: dict = {}     # source -> its nvcc job, started by start_all
_seconds: dict = {}     # source -> seconds its nvcc took


def nvcc_path() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built from source at first use and need the "
                       "CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; returns the job
    (its process, files, start time and a thread that waits for it) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    job = {"proc": subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
           "tmp": tmp, "target": target, "t0": time.perf_counter()}

    def reap():
        job["out"], _ = job["proc"].communicate()
        job["seconds"] = time.perf_counter() - job["t0"]
    job["thread"] = threading.Thread(target=reap, daemon=True)
    job["thread"].start()
    return job


def _finish(name, job):
    if job is None:
        return
    job["thread"].join()
    proc, tmp, target = job["proc"], job["tmp"], job["target"]
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{job['out']}")
    target.with_suffix(".ptxas.txt").write_text(job["out"])
    os.replace(tmp, target)   # atomic: a concurrent builder sees all or none
    _seconds[name] = job["seconds"]


def start_all(names=SOURCES):
    """Start nvcc for every named source not built yet, all at once, and
    return; ``load`` or ``wait`` finishes each build."""
    with _lock:
        for n in names:
            if n not in _pending:
                job = _start(n)
                if job is not None:
                    _pending[n] = job


def wait(names=SOURCES):
    """Finish the named sources' builds (started by ``start_all``, or
    built here)."""
    with _lock:
        for n in names:
            _finish(n, _pending.pop(n, None) or _start(n))


def build_all(names=SOURCES):
    """Build every named source, one nvcc each, all started together."""
    start_all(names)
    wait(names)


def build_seconds() -> dict:
    """{source: seconds its nvcc took} of the builds this process ran."""
    return dict(_seconds)


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _pending.pop(name, None) or _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


def report(name: str) -> str:
    """nvcc's output (ptxas -v: registers, spills, shared memory per
    kernel) from the build of csrc/<name>.cu's current library."""
    path = _target(name).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""
