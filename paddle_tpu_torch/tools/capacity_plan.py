"""Serve capacity planner: analytic TTFT / p99 prediction and its
closed-loop validation against the telemetry hub (tools/capacity_plan.py
for the port).

    python -m paddle_tpu_torch.tools.capacity_plan                # GPT-2
    python -m paddle_tpu_torch.tools.capacity_plan --config tiny  # report
    python -m paddle_tpu_torch.tools.capacity_plan --validate [--on cpu]
    python -m paddle_tpu_torch.tools.capacity_plan --self-check

**Report** (default): prices the serve loop from the cost models alone —
``capacity.serve_evidence`` (the decode step's FLOPs from the per-op
registry, its bytes from the parameters and the KV read) as a roofline on
the card's peaks (``--device``, default ``h100-sxm``), prefill from the
registry, the weight publish over the between-node tier — and sweeps the
offered load up to and past the knee: predicted p50 / p99, rho and the
M/G/k wait per rate. No card, no serving, deterministic.

**Validate**: calibrates a DeviceProfile from the live tiny-GPT loop on
``--on`` (the card by default), then for each builtin spec (steady
Poisson, diurnal wave, flash crowd) replays the same seeded schedule
through the beat simulation (prediction) and through the real ServeLoop
scored by a TelemetryHub, and holds throughput and the p50s within
``FLAGS_capacity_p50_band_pct`` of the prediction and the p99s within
``FLAGS_capacity_p99_band_pct``. The section, with the headroom, is
written to ``--evidence`` (default ``capacity_evidence.json`` in the
port's build directory, ``paddle_tpu_torch/ops/cuda/.build/``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
DEFAULT_EVIDENCE = str(_PKG / "ops" / "cuda" / ".build" /
                       "capacity_evidence.json")

# the bands and knobs this tool runs with; self_check pins them against
# core/flags.py's defaults
CAPACITY_FLAG_DEFAULTS = {
    "FLAGS_capacity_p50_band_pct": 25.0,
    "FLAGS_capacity_p99_band_pct": 40.0,
    "FLAGS_capacity_knee_rho": 0.85,
    "FLAGS_capacity_calib_beats": 32,
}
TRAFFIC_FLAG_DEFAULTS = {
    "PADDLE_TRAFFIC_SEED": 0,
    "PADDLE_TRAFFIC_TIME_SCALE": 1.0,
    "PADDLE_TRAFFIC_CLIENTS": 4,
}

# the validation operating point: builtin specs at this rate / duration
# against the harness's tiny serve shape (build_tiny_loop)
VALIDATE_SPECS = ("steady", "diurnal", "flash")
VALIDATE_RATE = 40.0
VALIDATE_DURATION_S = 10.0
VALIDATE_SEED = 7
VALIDATE_SERVE = {"max_active": 8, "kv_blocks": 48, "block_size": 8,
                  "max_seq_len": 48}

_HEADROOM_CAP = 99.0
SWEEP_EVENTS = 2000


def evidence_for(config="tiny"):
    """``capacity.serve_evidence`` of the tiny loop's shape (f32, 8 slots,
    blocks of 8) or of GPT-2 small at phase 21's serve shape (bf16, 64
    slots, blocks of 128, prompt 32 + 64 new)."""
    from ..static import capacity as C
    from ..text.models.gpt import GPTConfig
    if config == "gpt2":
        return C.serve_evidence(GPTConfig(), 64, fill=64, block_size=128,
                                blocks=512, max_seq_len=1024,
                                dtype="bfloat16")
    return C.serve_evidence(GPTConfig.tiny(), VALIDATE_SERVE["max_active"],
                            fill=16, block_size=VALIDATE_SERVE["block_size"],
                            blocks=VALIDATE_SERVE["kv_blocks"],
                            max_seq_len=VALIDATE_SERVE["max_seq_len"],
                            dtype="float32", prompt=6, new=8)


# ---------------------------------------------------------------------------
# report (analytic, no card)
# ---------------------------------------------------------------------------

def report(device="h100-sxm", rate=None, duration_s=4.0, seed=None,
           config="gpt2"):
    import numpy as np

    from ..core import flags as _flags
    from ..static import capacity as C
    from ..text.models.gpt import GPTConfig
    from ..traffic import workload as W

    if seed is None:
        seed = int(_flags.flag("PADDLE_TRAFFIC_SEED"))
    ev = evidence_for(config)
    cfg = GPTConfig() if config == "gpt2" else GPTConfig.tiny()
    prof = C.analytic_profile(ev, device=device, gpt_cfg=cfg)
    probe = W.builtin_spec("steady", rate=rate or 100.0,
                           duration_s=duration_s)
    events = W.schedule(probe, seed)
    mean_new = float(np.mean([e.new_tokens for e in events]))
    mean_prompt = float(np.mean([e.prompt.size for e in events]))
    sd = ev["graphs"]["serve_decode"]["config"]
    slots = sd["slots"]
    knee = C.knee_rps(prof, slots=slots, mean_new=mean_new,
                      mean_prompt=mean_prompt)
    knee_rho = float(_flags.flag("FLAGS_capacity_knee_rho"))
    sweep = []
    for frac in (0.25, 0.5, 0.75, 0.9, 1.0, 1.1):
        r = max(0.5, knee * frac)
        # the card's knee lies at thousands of requests/s: cut the
        # window to ~SWEEP_EVENTS arrivals a point
        spec = W.builtin_spec("steady", rate=r, duration_s=min(
            duration_s, SWEEP_EVENTS / r))
        p = C.predict(spec, seed, prof, slots=slots,
                      kv_blocks=sd["blocks"], block_size=sd["block_size"])
        p["over_knee"] = p["rho"] > knee_rho
        sweep.append(p)
    param_bytes = float(ev["graphs"]["serve_decode"]["param_bytes"])
    return {
        "tool": "paddle_tpu_torch.tools.capacity_plan",
        "device": device, "config": config,
        "evidence": ev["graphs"]["serve_decode"]["cost_analysis"],
        "profile": prof.as_dict(),
        "knee_rps": round(knee, 3),
        "knee_rho": knee_rho,
        "sweep": sweep,
        "fleet": {"param_bytes": param_bytes,
                  "publish_wire_ms_x4_replicas":
                      round(C.publish_wire_ms(param_bytes, 4), 3)},
    }


# ---------------------------------------------------------------------------
# closed-loop validation
# ---------------------------------------------------------------------------

def _err_pct(pred, obs):
    if pred in (None, 0) or obs is None:
        return None
    return round(100.0 * abs(obs - pred) / abs(pred), 1)


def validate(evidence_path=None, update_evidence=True, device=None):
    """Calibrate on ``device`` (None: the current device, the card by
    default), predict each builtin spec, replay it through the real
    harness with the hub scoring, and hold the observation to the bands.
    Returns the capacity_validation section (ok=False if any metric lands
    outside its band)."""
    from ..core import flags as _flags
    from ..device import device_scope
    from ..static import capacity as C

    band50 = float(_flags.flag("FLAGS_capacity_p50_band_pct"))
    band99 = float(_flags.flag("FLAGS_capacity_p99_band_pct"))
    attempts = 0
    with device_scope(device):
        while True:
            attempts += 1
            prof = C.calibrate(VALIDATE_SERVE)
            section = _validate_once(prof, band50, band99)
            # host wall-clock drifts at minute scale with background
            # load: one recalibrate-and-retry (a fresh profile and fresh
            # observations, never fitted on the scored runs) absorbs it
            if section["ok"] or attempts >= 2:
                break
    section["attempts"] = attempts
    section["profile"] = prof.as_dict()
    if update_evidence:
        path = evidence_path or DEFAULT_EVIDENCE
        ev = {}
        if os.path.exists(path):
            with open(path) as f:
                ev = json.load(f)
        ev.setdefault("graphs", {})["capacity_validation"] = section
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(ev, f, indent=1, sort_keys=True)
            f.write("\n")
    return section


def score(pred, obs, band50, band99):
    """{metric: error %} of a hub-scored replay against its prediction,
    and whether the replay holds: scored by the hub, no error, every
    event completed, every metric within its band."""
    errs = {
        "throughput_rps": _err_pct(pred["throughput_rps"],
                                   obs.throughput_rps),
        "ttft_p50": _err_pct(pred["ttft_ms"]["p50"], obs.ttft_ms.get("p50")),
        "ttft_p99": _err_pct(pred["ttft_ms"]["p99"], obs.ttft_ms.get("p99")),
        "token_p50": _err_pct(pred["token_ms"]["p50"],
                              obs.token_ms.get("p50")),
        "token_p99": _err_pct(pred["token_ms"]["p99"],
                              obs.token_ms.get("p99")),
    }
    ok = (obs.scored_by == "hub" and obs.errors == 0
          and obs.completed == obs.events)
    for key, e in errs.items():
        band = band99 if key.endswith("p99") else band50
        if e is None or e > band:
            ok = False
    return errs, ok


def _validate_once(prof, band50, band99):
    from ..core import telemetry
    from ..static import capacity as C
    from ..traffic import harness as H
    from ..traffic import workload as W

    specs = {}
    worst = {"p50_class": 0.0, "p99_class": 0.0}
    ok = True
    for name in VALIDATE_SPECS:
        spec = W.builtin_spec(name, rate=VALIDATE_RATE,
                              duration_s=VALIDATE_DURATION_S)
        pred = C.predict(spec, VALIDATE_SEED, prof,
                         slots=VALIDATE_SERVE["max_active"],
                         kv_blocks=VALIDATE_SERVE["kv_blocks"],
                         block_size=VALIDATE_SERVE["block_size"])
        hub = telemetry.TelemetryHub(eval_s=5.0)
        try:
            obs = H.run_spec(spec, seed=VALIDATE_SEED,
                             serve_cfg=VALIDATE_SERVE, hub=hub)
        finally:
            hub.stop()
        errs, spec_ok = score(pred, obs, band50, band99)
        for key, e in errs.items():
            cls = "p99_class" if key.endswith("p99") else "p50_class"
            if e is not None:
                worst[cls] = max(worst[cls], e)
        ok = ok and spec_ok
        specs[name] = {
            "predicted": {k: pred[k] for k in
                          ("throughput_rps", "ttft_ms", "token_ms",
                           "offered_rps", "rho", "knee_rps",
                           "backpressure_ticks", "events")},
            "observed": {"throughput_rps": obs.throughput_rps,
                         "ttft_ms": obs.ttft_ms,
                         "token_ms": obs.token_ms,
                         "completed": obs.completed,
                         "errors": obs.errors,
                         "backpressure_waits": obs.backpressure_waits,
                         "scored_by": obs.scored_by,
                         "schedule_digest": obs.schedule_digest[:16]},
            "err_pct": errs,
            "ok": spec_ok,
        }
    headroom = min(
        band50 / max(worst["p50_class"], band50 / _HEADROOM_CAP),
        band99 / max(worst["p99_class"], band99 / _HEADROOM_CAP))
    return {
        "config": dict(VALIDATE_SERVE, rate_rps=VALIDATE_RATE,
                       duration_s=VALIDATE_DURATION_S,
                       seed=VALIDATE_SEED),
        "bands_pct": {"p50": band50, "p99": band99},
        "specs": specs,
        "worst_err_pct": {k: round(v, 1) for k, v in worst.items()},
        "band_headroom_x": round(headroom if ok else 0.0, 3),
        "ok": ok,
    }


# ---------------------------------------------------------------------------
# self-check
# ---------------------------------------------------------------------------

def self_check():
    """This tool's knobs against the port's flag defaults and the
    harness's tiny serve shape; the percentiles from core.slo."""
    import inspect

    from ..core import flags as _flags
    from ..traffic import harness as H

    problems = []
    for table in (CAPACITY_FLAG_DEFAULTS, TRAFFIC_FLAG_DEFAULTS):
        for name, want in table.items():
            defn = _flags._DEFS.get(name)
            if defn is None:
                problems.append(f"capacity_plan: flag {name} not defined "
                                "in core/flags.py")
            elif defn[1] != want:
                problems.append(f"capacity_plan: default drift for {name} "
                                f"({defn[1]!r} != {want!r})")
    src = inspect.getsource(H.build_tiny_loop)
    for key, want in VALIDATE_SERVE.items():
        token = f'setdefault("{key}", {want})'
        if token not in src:
            problems.append(
                f"capacity_plan: VALIDATE_SERVE[{key!r}]={want} is not the "
                f"harness build_tiny_loop default ({token} missing)")
    with open(os.path.abspath(__file__)) as f:
        own = f.read()
    if ("def " + "percentile") in own:  # split so the pin can't self-match
        problems.append("capacity_plan: grew a private percentile; use "
                        "core.slo")
    return problems


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--validate", action="store_true")
    p.add_argument("--evidence", default=DEFAULT_EVIDENCE)
    p.add_argument("--device", default="h100-sxm",
                   help="the peaks the analytic report prices against")
    p.add_argument("--config", default="gpt2", choices=("tiny", "gpt2"))
    p.add_argument("--on", default=None,
                   help="where --validate runs the loop: cpu or gpu "
                        "(default: the card)")
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--no-update", action="store_true",
                   help="validate without writing --evidence")
    p.add_argument("--self-check", "--self_check", action="store_true",
                   dest="self_check")
    args = p.parse_args(argv)
    if args.self_check:
        problems = self_check()
        for prob in problems:
            print(f"SELF-CHECK FAIL: {prob}")
        if problems:
            return 1
        print("capacity_plan self-check OK")
        return 0
    if args.validate:
        section = validate(args.evidence, update_evidence=not args.no_update,
                           device=args.on)
        print(json.dumps(section, indent=1, sort_keys=True))
        return 0 if section["ok"] else 1
    print(json.dumps(report(device=args.device, rate=args.rate,
                            config=args.config), indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
