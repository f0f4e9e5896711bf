"""Build and drive the C ABI's scripted demo host
(``_native/demo/pd_client.c``) from Python: the tests and the card's
smoke phase run a real C process over ``libpaddle_tpu_capi.so`` through
this module.

    exe = build(lib, out_dir)                 # gcc, linked to ``lib``
    plan = Plan(tmp)
    plan.cpu()                                # set_device("cpu") first
    plan.predictor(prefix)
    plan.input(np_array)
    out = plan.run(3)                         # path of the outputs file
    res = run_plan(exe, plan)                 # a Result
    res.outputs(out)                          # [np.float32 arrays]

``build`` links the demo to the library at ``lib`` by its full path with
its directory on the rpath, so a host with two libraries of this name
(the JAX package's and the port's) loads the one it was given; the
``lib`` command prints which one it did.
"""
from __future__ import annotations

import os
import subprocess
import time

import numpy as np

from .. import _native

__all__ = ["build", "Plan", "Result", "run_plan", "start_plan", "finish_plan",
           "DTYPE_CODES"]

DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1,
               np.dtype(np.int64): 2}
_SRC = os.path.join(os.path.dirname(os.path.abspath(_native.__file__)),
                    "demo", "pd_client.c")


def build(lib, out_dir, name="pd_client"):
    """Compile the demo host against the C header and ``lib``; returns the
    executable's path."""
    exe = os.path.join(out_dir, name)
    subprocess.run(
        ["gcc", "-O1", _SRC, "-o", exe,
         f"-I{os.path.dirname(_native.capi_header())}", lib,
         f"-Wl,-rpath,{os.path.dirname(os.path.abspath(lib))}",
         *_native.embed_flags()], check=True, capture_output=True,
        text=True)
    return exe


class Plan:
    """The commands of one demo run (see the C source for each), with the
    input and output files under ``work``."""

    def __init__(self, work):
        self.work = str(work)
        self.lines = []
        self._files = 0

    def _file(self, stem):
        self._files += 1
        return os.path.join(self.work, f"{stem}{self._files}.bin")

    def py(self, code):
        if "\n" in code:
            raise ValueError("a py command is one line")
        self.lines.append(f"py {code}")

    def cpu(self):
        """The host initializes Python and puts the port on the CPU before
        its first PD_* call (the ABI has no device argument)."""
        self.py("import paddle_tpu_torch; paddle_tpu_torch.set_device('cpu')")

    def lib(self):
        self.lines.append("lib")

    def predictor(self, prefix, key_hex=""):
        self.lines.append(f"predictor {prefix} {key_hex}".rstrip())

    def trainer(self, artifact):
        self.lines.append(f"trainer {artifact}")

    def clear(self):
        self.lines.append("clear")

    def input(self, array):
        a = np.ascontiguousarray(array)
        path = self._file("in")
        a.tofile(path)
        self.lines.append(" ".join(
            ["input", str(DTYPE_CODES[a.dtype]), path, str(a.ndim),
             *map(str, a.shape)]))

    def run(self, n=1):
        """``n`` predictor runs; returns the file of the last one's
        outputs."""
        path = self._file("out")
        self.lines.append(f"run {n} {path}")
        return path

    def step(self, n=1):
        self.lines.append(f"step {n}")

    def save(self, path):
        self.lines.append(f"save {path}")

    def wait_for(self, path):
        """The host's embedded interpreter waits until ``path`` exists: a
        caller that starts the host early holds its timed commands until
        the caller's own work is done."""
        self.py(f"import os, time; [time.sleep(0.02) for _ in iter("
                f"lambda: os.path.exists({str(path)!r}), True)]")


class Result:
    """A finished demo run: its return code, stdout, stderr, seconds, and
    what its stdout reported."""

    def __init__(self, proc, seconds):
        self.returncode = proc.returncode
        self.stdout, self.stderr = proc.stdout, proc.stderr
        self.seconds = seconds
        self.lib = None
        self.losses, self.run_ms, self.step_ms = [], [], []
        self.errors = []
        for line in proc.stdout.splitlines():
            word, _, rest = line.partition(" ")
            if word == "lib":
                self.lib = rest
            elif word == "loss":
                self.losses.append(float.fromhex(rest))
            elif word == "run" and rest.startswith("ms "):
                self.run_ms.append(float(rest[3:]))
            elif word == "step" and rest.startswith("ms "):
                self.step_ms.append(float(rest[3:]))
            elif rest.startswith("error "):
                self.errors.append((word, rest[6:]))

    def check(self):
        assert self.returncode == 0, (
            f"pd_client exited {self.returncode}:\n{self.stdout[-4000:]}\n"
            f"{self.stderr[-4000:]}")
        return self

    @staticmethod
    def outputs(path):
        """The outputs file of a ``run``: [np.float32 array, ...]."""
        with open(path, "rb") as f:
            blob = f.read()
        n, pos, outs = int(np.frombuffer(blob, np.int32, 1, 0)[0]), 4, []
        for _ in range(n):
            nd = int(np.frombuffer(blob, np.int32, 1, pos)[0])
            shape = tuple(int(d) for d in np.frombuffer(blob, np.int64, nd,
                                                        pos + 4))
            pos += 4 + 8 * nd
            size = int(np.prod(shape))
            outs.append(np.frombuffer(blob, np.float32, size, pos)
                        .reshape(shape).copy())
            pos += 4 * size
        return outs


def start_plan(exe, plan, env=None):
    """Start the demo over ``plan`` with ``_native.capi_env(env)`` and
    return at once; ``finish_plan`` waits for it."""
    path = os.path.join(plan.work, "plan.txt")
    with open(path, "w") as f:
        f.write("\n".join(plan.lines) + "\n")
    proc = subprocess.Popen([exe, path], env=_native.capi_env(env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, time.perf_counter()


def finish_plan(started, timeout=600):
    """The Result of a demo run from ``start_plan``; a run past
    ``timeout`` seconds is killed and raises."""
    proc, t = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return Result(subprocess.CompletedProcess(proc.args, proc.returncode,
                                              out, err),
                  time.perf_counter() - t)


def run_plan(exe, plan, env=None, timeout=600):
    """Run the demo over ``plan`` with ``_native.capi_env(env)``."""
    return finish_plan(start_plan(exe, plan, env), timeout)
