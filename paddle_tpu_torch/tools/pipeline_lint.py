"""Async-executor pipeline config lint (tools/pipeline_lint.py for the
port).

Owns the canonical train-mode pipeline config of the port
(``PIPELINE_CFG``) and checks, without running anything costly, that the
three places it is encoded cannot drift apart:

1. ``chip_smoke.py``'s phase 23(a) ``train_from_dataset`` constants (the
   measured evidence on the card: ``P23_STEPS``, ``P23_BATCHES`` and the
   in-flight and scan modes of ``P23_MODES``), read from the script's
   source without importing it;
2. ``core/flags.py``'s ``FLAGS_executor_*`` declared defaults (what every
   training loop gets);
3. the scan megastep of ``static/pipeline_runner.py``: a tiny program on
   the CPU through ``PipelineRunner(scan_steps=K)`` must fuse its steps
   into steps // K megasteps (``executor/scan_megasteps``), the proof that
   K steps become one megastep.

It reads neither ``bench.py`` nor ``tools/hlo_evidence.py``: those measure
the JAX package.

    python -m paddle_tpu_torch.tools.pipeline_lint      # exit 1 on drift
"""
from __future__ import annotations

import ast
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# canonical train-mode pipeline config (chip_smoke.py phase 23(a))
PIPELINE_CFG = {"steps": 24, "batches": 16, "scan_k": 4, "inflight": 2}


def smoke_constants(path=None):
    """{name: value} of the module-level constants of ``chip_smoke.py``
    that are literals, read with ``ast``."""
    path = path or os.path.join(_ROOT, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            names = ([target] if isinstance(target, ast.Name)
                     else list(getattr(target, "elts", [])))
            values = ([node.value] if isinstance(target, ast.Name)
                      else list(getattr(node.value, "elts", [])))
            for n, v in zip(names, values):
                try:
                    out[n.id] = ast.literal_eval(v)
                except (ValueError, TypeError, SyntaxError, AttributeError):
                    pass
    return out


def _smoke_problems(cfg, consts):
    problems = []
    for key, name in (("steps", "P23_STEPS"), ("batches", "P23_BATCHES")):
        if name not in consts:
            problems.append(f"pipeline_lint: chip_smoke.py no longer sets "
                            f"{name}")
        elif consts[name] != cfg[key]:
            problems.append(
                f"pipeline_lint: chip_smoke.py {name}={consts[name]} but "
                f"PIPELINE_CFG says {cfg[key]} — update the canonical config")
    modes = {m[0]: (m[1], m[2]) for m in consts.get("P23_MODES", ())}
    want = {"sync": (0, 0), f"inflight{cfg['inflight']}": (cfg["inflight"], 0),
            f"inflight{cfg['inflight']}_scan{cfg['scan_k']}":
                (cfg["inflight"], cfg["scan_k"])}
    if modes != want:
        problems.append(
            f"pipeline_lint: chip_smoke.py P23_MODES {modes} != {want} "
            "from PIPELINE_CFG — the card measures another pipeline")
    if cfg["steps"] % cfg["scan_k"]:
        problems.append(
            f"pipeline_lint: {cfg['steps']} steps are not whole megasteps "
            f"of K {cfg['scan_k']}")
    return problems


def _flag_problems(cfg):
    from ..core import flags as _flags
    defs = _flags._DEFS
    problems = []
    for name in ("FLAGS_executor_max_inflight", "FLAGS_executor_scan_steps",
                 "FLAGS_executor_cache_size"):
        if name not in defs:
            problems.append(f"pipeline_lint: flag {name} is gone but the "
                            "pipeline runner depends on it")
    if "FLAGS_executor_max_inflight" in defs and \
            int(defs["FLAGS_executor_max_inflight"][1]) != cfg["inflight"]:
        problems.append(
            "pipeline_lint: FLAGS_executor_max_inflight default "
            f"{defs['FLAGS_executor_max_inflight'][1]} != inflight "
            f"{cfg['inflight']} — the card would measure a pipeline depth "
            "users don't get by default")
    if "FLAGS_executor_scan_steps" in defs and \
            int(defs["FLAGS_executor_scan_steps"][1]) != 0:
        problems.append(
            "pipeline_lint: FLAGS_executor_scan_steps default must stay 0 "
            "(scan fusion is opt in; the card's mode passes K explicitly)")
    return problems


def scan_megasteps(k, steps):
    """Megasteps a tiny CPU program makes through ``PipelineRunner`` over
    ``steps`` shape-stable batches at ``scan_steps=k``."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from .. import static
    from ..core import monitor
    from ..device import device_scope
    with device_scope("cpu"):
        paddle.enable_static()
        try:
            main = static.Program("pipeline_lint")
            with static.program_guard(main, static.Program()):
                x = static.data("x", [4, 3], "float32")
                loss = paddle.ops.mean(paddle.nn.Linear(3, 1)(x))
                paddle.optimizer.SGD(learning_rate=0.1).minimize(loss)
        finally:
            paddle.disable_static()
        rng = np.random.RandomState(0)
        feeds = [{"x": rng.rand(4, 3).astype("float32")}
                 for _ in range(steps)]
        before = monitor.stat_get("executor/scan_megasteps")
        with static.PipelineRunner(static.Executor(), main,
                                   fetch_list=[loss], max_inflight=2,
                                   scan_steps=k) as runner:
            for handles in runner.run(feeds):
                pass
        return monitor.stat_get("executor/scan_megasteps") - before


def self_check(cfg=None, smoke_path=None):
    """The drift between the three encodings, as problem strings."""
    cfg = dict(PIPELINE_CFG if cfg is None else cfg)
    problems = _smoke_problems(cfg, smoke_constants(smoke_path))
    try:
        problems += _flag_problems(cfg)
    except ImportError as e:
        return problems + [f"pipeline_lint: flags import failed: {e!r}"]
    if cfg["scan_k"] < 2:
        problems.append("pipeline_lint: scan_k must be >= 2 — a megastep "
                        "of one step fuses nothing")
    else:
        steps = 2 * cfg["scan_k"] + 1          # a remainder runs unfused
        got = scan_megasteps(cfg["scan_k"], steps)
        if got != steps // cfg["scan_k"]:
            problems.append(
                f"pipeline_lint: PipelineRunner(scan_steps="
                f"{cfg['scan_k']}) made {got} megasteps of {steps} steps, "
                f"not {steps // cfg['scan_k']}")
    return problems


def main(argv=None):
    problems = self_check()
    for p in problems:
        print(p)
    print("pipeline_lint:",
          "clean" if not problems else f"{len(problems)} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
