"""Analytic serve capacity model (paddle_tpu/static/capacity.py): predict
TTFT and token p50 / p99 and the saturation knee from an offered-load
spec, before running any traffic.

- **Decode beat cost** from a decode step's evidence (``serve_evidence``:
  FLOPs from the per-op FLOPs registry over one decode step's Program,
  bytes from the parameters and the KV read at the typical fill), priced
  as a roofline against the card's peaks and split into a fixed
  weight-read floor and a per-active-stream slope (``analytic_profile``).
  The JAX package reads XLA's TPU cost analysis from ``HLO_EVIDENCE.json``
  there; the port builds the same dict from its own accounting.
- **Prefill cost** priced by the same registry over a recorded GPT
  ``static.Program`` at each prefill bucket
  (``spmd_analyzer.analyze_flops``).
- **Topology tier costs**: the weight publish to N serve replicas over the
  between-node tier, ``FLAGS_topology_dcn_gbps``.
- **Admission and pool queueing**: the ServeLoop's FCFS +
  worst-case-block admission gate replayed as a deterministic
  discrete-event simulation of the scheduler beat over the workload
  generator's own schedule (``simulate``), a closed-form M/G/k wait
  estimate (``queue_wait_ms``, Allen-Cunneen) and the knee
  ``lambda_knee = slots / (E[n]*beat + slots*E[prefill])``.
- **Measured overheads**: ``calibrate`` fits the beat base and slope and
  the per-bucket prefill from a live ServeLoop on the entry point's
  device (the card by default; ``calibrate_cpu`` pins the CPU), which is
  what ``paddle_tpu_torch.tools.capacity_plan --validate`` scores the
  model with.

Everything past the calibration is host math over a deterministic
schedule: two calls with the same (spec, seed, profile) return identical
predictions, and equal the JAX package's.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["DeviceProfile", "DEVICE_PEAKS", "calibrate", "calibrate_cpu",
           "analytic_profile", "serve_evidence", "prefill_flops",
           "publish_wire_ms", "simulate", "predict", "knee_rps",
           "queue_wait_ms"]

# The card's peaks that the analytic path prices against: the H100 SXM
# at 700 W, dense bf16 tensor-core FLOP/s and HBM3 bytes/s (NVIDIA H100
# data sheet). No TPU entry: the port runs on the card only.
DEVICE_PEAKS = {
    "h100-sxm": {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def _peaks(device: str) -> Dict[str, float]:
    if device not in DEVICE_PEAKS:
        raise ValueError(f"capacity: no peaks for device {device!r}; "
                         f"known: {sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[device]


def _bucket(n: int) -> int:
    """The serve prefill pad bucket a prompt of length n falls into."""
    b = 8
    while b < n:
        b *= 2
    return b
@dataclass
class DeviceProfile:
    """What one serving device costs, in the two quantities the beat
    simulation consumes: an affine decode-beat model
    `beat_ms(active) = base + slope*active` and a per-bucket prefill
    table. `source` records how it was derived ("calibrated-<device type>"
    from live measurement, "analytic-<device>" from the cost models)."""

    source: str
    beat_ms_base: float
    beat_ms_per_active: float
    prefill_ms: Dict[int, float] = field(default_factory=dict)
    host_overhead_ms: float = 0.0
    # per-admission LATENCY overhead under paced load (scheduler wake
    # from the idle wait, submit-side key/dispatch) — felt by the
    # arriving request's TTFT but NOT serialized into the beat timeline
    # (the wakeup overlaps decode of other streams). Invisible to a
    # hot-loop measurement; fitted by the refinement pass.
    admit_ms: float = 0.0
    # the SERIALIZED share of the admission overhead (per-admission
    # scheduler work beyond prefill compute that does block the beat
    # loop, so arrival clumps queue behind it). Separated from admit_ms
    # by the second, high-rate refinement operating point — at low rate
    # the two are indistinguishable, at high rate only this one bends
    # the TTFT tail.
    admit_serial_ms: float = 0.0
    # host-jitter tail offsets: the p99 − p50 spread the OS scheduler
    # adds on top of anything a beat-cost model can derive. Fitted once
    # at the refinement operating point, held to every other spec.
    ttft_tail_ms: float = 0.0
    token_tail_ms: float = 0.0

    def beat_ms(self, active: int) -> float:
        return (self.beat_ms_base + self.host_overhead_ms
                + self.beat_ms_per_active * max(0, int(active)))

    def prefill_cost_ms(self, prompt_len: int) -> float:
        b = _bucket(prompt_len)
        if b in self.prefill_ms:
            return self.prefill_ms[b] + self.host_overhead_ms
        if not self.prefill_ms:
            return self.host_overhead_ms
        # extrapolate linearly in bucket width from the nearest bucket
        ref = min(self.prefill_ms, key=lambda k: abs(k - b))
        return self.prefill_ms[ref] * (b / ref) + self.host_overhead_ms

    def as_dict(self) -> Dict:
        return {"source": self.source,
                "beat_ms_base": round(self.beat_ms_base, 4),
                "beat_ms_per_active": round(self.beat_ms_per_active, 4),
                "prefill_ms": {str(k): round(v, 4)
                               for k, v in sorted(self.prefill_ms.items())},
                "host_overhead_ms": round(self.host_overhead_ms, 4),
                "admit_ms": round(self.admit_ms, 4),
                "admit_serial_ms": round(self.admit_serial_ms, 4),
                "ttft_tail_ms": round(self.ttft_tail_ms, 4),
                "token_tail_ms": round(self.token_tail_ms, 4)}

    @classmethod
    def from_dict(cls, d: Dict) -> "DeviceProfile":
        return cls(source=d["source"],
                   beat_ms_base=float(d["beat_ms_base"]),
                   beat_ms_per_active=float(d["beat_ms_per_active"]),
                   prefill_ms={int(k): float(v)
                               for k, v in d.get("prefill_ms", {}).items()},
                   host_overhead_ms=float(d.get("host_overhead_ms", 0.0)),
                   admit_ms=float(d.get("admit_ms", 0.0)),
                   admit_serial_ms=float(d.get("admit_serial_ms", 0.0)),
                   ttft_tail_ms=float(d.get("ttft_tail_ms", 0.0)),
                   token_tail_ms=float(d.get("token_tail_ms", 0.0)))


# ---------------------------------------------------------------------------
# profiles: measured (a live loop) and analytic (the card's peaks)
# ---------------------------------------------------------------------------

def calibrate(serve_cfg=None, *, beats: Optional[int] = None,
              buckets=(8, 16, 32), refine: bool = True, device=None,
              loop=None, refine_specs=None) -> DeviceProfile:
    """Fit a DeviceProfile from a live ServeLoop on ``device`` (None: the
    current device, the card unless ``set_device("cpu")``): per-bucket
    prefill from single-request TTFT, beat base and slope from per-token
    latency at two active levels. ``loop`` defaults to the harness's tiny
    GPT loop (``build_tiny_loop(serve_cfg)``); a caller's loop must match
    ``serve_cfg`` (max_active, kv_blocks, block_size). ``refine_specs``
    are the two refinement operating points (low and high rate; default:
    the builtin steady spec at 25 and 60 requests/s for 6 s)."""
    from ..core import flags as _flags
    from ..core.slo import percentile
    from ..device import device_scope, resolve_device
    from ..traffic.harness import build_tiny_loop

    if beats is None:
        beats = int(_flags.flag("FLAGS_capacity_calib_beats"))
    with device_scope(device):
        kind = resolve_device().type
        if loop is None:
            _net, loop = build_tiny_loop(serve_cfg)
        cap = loop._cap
        buckets = tuple(b for b in buckets if b + 2 <= cap)
        # first launches and kernel builds outside the measurement
        for b in buckets:
            loop.serve([np.arange(1, b + 1, dtype=np.int64)],
                       max_new_tokens=2)
        loop.start()
        try:
            prefill_ms: Dict[int, float] = {}
            for b in buckets:
                samples = []
                for _ in range(3):
                    r = loop.submit(np.arange(1, b + 1, dtype=np.int64),
                                    max_new_tokens=2)
                    r.result(timeout=120)
                    samples.append(r.ttft_s * 1e3)
                prefill_ms[b] = percentile(samples, 50)

            def beat_at(k):
                n = max(4, min(beats, cap - buckets[0]))
                reqs = [loop.submit(
                    np.arange(1, buckets[0] + 1, dtype=np.int64),
                    max_new_tokens=n) for _ in range(k)]
                vals = []
                for r in reqs:
                    r.result(timeout=300)
                    vals.append(r.per_token_s * 1e3)
                return percentile(vals, 50)

            k2 = max(2, min(4, loop._A))
            b1 = beat_at(1)
            b2 = beat_at(k2)
        finally:
            loop.stop()
        slope = max(0.0, (b2 - b1) / max(1, k2 - 1))
        base = max(1e-4, b1 - slope)
        prof = DeviceProfile(source=f"calibrated-{kind}", beat_ms_base=base,
                             beat_ms_per_active=slope,
                             prefill_ms=prefill_ms)
        if refine:
            _refine(prof, serve_cfg, loop=loop, specs=refine_specs)
    return prof


def calibrate_cpu(serve_cfg=None, *, beats: Optional[int] = None,
                  buckets=(8, 16, 32), refine: bool = True) -> DeviceProfile:
    """``calibrate`` on the CPU's tiny loop (the JAX package's
    ``calibrate_cpu``)."""
    return calibrate(serve_cfg, beats=beats, buckets=buckets, refine=refine,
                     device="cpu")


_REFINE_SEED = 123


def _refine(prof: DeviceProfile, serve_cfg=None, passes: int = 2,
            loop=None, specs=None):
    """System identification: the hot-loop fit misses the overhead a
    paced arrival pays (idle-wait wakeup, submit-side dispatch work). Run
    a low-rate spec through the real harness and fit ``admit_ms`` from
    the TTFT p50 gap and a beat-base bump from the token p50 gap, then
    split the admission overhead at a high-rate spec and fit the tails
    (the JAX package's ``_refine_cpu``)."""
    from ..traffic import workload as W
    from ..traffic.harness import run_spec

    if specs is None:
        specs = (W.builtin_spec("steady", rate=25.0, duration_s=6.0),
                 W.builtin_spec("steady", rate=60.0, duration_s=6.0))
    spec_a, spec_b = specs
    sc = dict(serve_cfg or {})
    slots = sc.get("max_active", 8)
    blocks = sc.get("kv_blocks", 48)
    bs = sc.get("block_size", 8)

    def observe(spec):
        runs = [run_spec(spec, seed=_REFINE_SEED, serve_cfg=serve_cfg,
                         loop=loop)
                for _ in range(max(1, passes))]
        med = lambda xs: float(np.median([x for x in xs  # noqa: E731
                                          if x is not None] or [0.0]))
        return {"ttft50": med([r.ttft_ms.get("p50") for r in runs]),
                "ttft99": med([r.ttft_ms.get("p99") for r in runs]),
                "tok50": med([r.token_ms.get("p50") for r in runs]),
                "tok99": med([r.token_ms.get("p99") for r in runs])}

    def pred(spec):
        return predict(spec, _REFINE_SEED, prof, slots=slots,
                       kv_blocks=blocks, block_size=bs)

    obs_a = observe(spec_a)
    p = pred(spec_a)
    if obs_a["tok50"] and p["token_ms"]["p50"]:
        prof.beat_ms_base += max(
            0.0, obs_a["tok50"] - p["token_ms"]["p50"])
    if obs_a["ttft50"] and p["ttft_ms"]["p50"]:
        prof.admit_ms += max(
            0.0, obs_a["ttft50"] - p["ttft_ms"]["p50"])
    # with the p50s anchored, the low-rate TTFT p99 gap is host jitter
    p = pred(spec_a)
    if obs_a["ttft99"] and p["ttft_ms"]["p99"]:
        prof.ttft_tail_ms = max(
            0.0, obs_a["ttft99"] - p["ttft_ms"]["p99"])
    # point B: bisect how much of the admission overhead serializes
    obs_b = observe(spec_b)
    if obs_b["ttft99"]:
        total = prof.admit_ms
        lo, hi = 0.0, total
        for _ in range(12):
            mid = (lo + hi) / 2
            prof.admit_serial_ms = mid
            prof.admit_ms = total - mid
            pb = pred(spec_b)["ttft_ms"]["p99"]
            if pb is not None and pb < obs_b["ttft99"]:
                lo = mid
            else:
                hi = mid
        prof.admit_serial_ms = (lo + hi) / 2
        prof.admit_ms = total - prof.admit_serial_ms
    # token tail: the mean of both operating points' residuals
    deltas = []
    for spec, obs in ((spec_a, obs_a), (spec_b, obs_b)):
        pp = pred(spec)["token_ms"]["p99"]
        if obs["tok99"] and pp:
            deltas.append(max(0.0, obs["tok99"] - pp))
    if deltas:
        prof.token_tail_ms = float(np.mean(deltas))


def _record_gpt(name, shape, gpt_cfg):
    """A static Program of one GPT forward over int64 ids of ``shape``,
    recorded on the CPU. Recording computes nothing and the FLOPs model
    reads shapes only, so the model's truncated-normal init (~10 s of CPU
    at GPT-2 small) is skipped: the parameters keep their layers'
    default init."""
    from .. import disable_static, enable_static
    from ..device import device_scope
    from ..text.models import gpt as gpt_mod
    from . import Program, data, program_guard
    from .program import in_static_mode

    cfg = gpt_cfg or gpt_mod.GPTConfig.tiny()
    GPT = gpt_mod.GPT
    was_static = in_static_mode()
    init, gpt_mod._bert_init = gpt_mod._bert_init, lambda *a, **k: None
    with contextlib.ExitStack() as undo:
        undo.callback(setattr, gpt_mod, "_bert_init", init)
        undo.enter_context(device_scope("cpu"))
        if not was_static:
            enable_static()
            undo.callback(disable_static)
        main = Program(name)
        with program_guard(main):
            ids = data("input_ids", list(shape), "int64")
            net = GPT(cfg)
            net(ids)
        return main


def prefill_flops(prompt_len: int, gpt_cfg=None) -> float:
    """Forward FLOPs of one prefill at ``prompt_len`` (padded to its
    bucket), priced by the per-op FLOPs registry over a recorded GPT
    Program, not a hand formula."""
    from .spmd_analyzer import analyze_flops
    main = _record_gpt(f"capacity_prefill_{prompt_len}",
                       (1, _bucket(prompt_len)), gpt_cfg)
    return analyze_flops(main)["total"]


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def serve_evidence(gpt_cfg=None, slots: int = 64, *, fill: int = 64,
                   block_size: int = 128, blocks: int = 512,
                   max_seq_len: int = 1024, dtype: str = "bfloat16",
                   prompt: int = 32, new: int = 64) -> Dict:
    """The decode step's evidence in the layout of the JAX package's
    ``HLO_EVIDENCE.json`` ``graphs.serve_decode`` record, from the port's
    own accounting:

    - ``flops``: ``analyze_flops`` over one decode step's Program (a GPT
      forward of one token in each of ``slots`` rows: the weight GEMMs
      and the LM head; the attention's reads of the cache are bytes);
    - ``kv_bytes_per_step``: the K and V columns that the paged kernel
      reads in a step at the typical ``fill`` (whole blocks: ceil(fill /
      block_size) * block_size columns a slot, every layer);
    - ``bytes_accessed``: the parameters in ``dtype`` plus that KV read."""
    from ..text.models.gpt import GPTConfig
    from .spmd_analyzer import analyze_flops

    cfg = gpt_cfg or GPTConfig.tiny()
    main = _record_gpt("capacity_decode", (int(slots), 1), cfg)
    flops = analyze_flops(main)["total"]
    width = _DTYPE_BYTES[dtype]
    n_params = sum(int(np.prod(v.shape))
                   for v in main.persistable_vars.values())
    param_bytes = float(n_params * width)

    def kv(cols):
        return float(int(slots) * cols * cfg.num_layers * 2
                     * cfg.hidden_size * width)

    live = -(-int(fill) // int(block_size)) * int(block_size)
    typical = kv(live)
    return {"graphs": {"serve_decode": {
        "config": {"slots": int(slots), "block_size": int(block_size),
                   "blocks": int(blocks), "max_seq_len": int(max_seq_len),
                   "prompt": int(prompt), "new": int(new),
                   "dtype": dtype},
        "cost_analysis": {"flops": float(flops),
                          "bytes_accessed": param_bytes + typical},
        "param_bytes": param_bytes,
        "kv_bytes_per_step": {
            "block_size": int(block_size), "slots": int(slots),
            "typical_fill_tokens": int(fill), "typical_live_cols": live,
            "typical_kv_bytes_per_step": typical,
            "full_cache_bytes_per_step": kv(int(max_seq_len)),
            "model": "per-step KV reads: the paged kernel reads "
                     "ceil(live/bs)*bs columns a slot"}}}}


def analytic_profile(evidence: Dict, *, device: str = "h100-sxm",
                     buckets=(8, 16, 32), gpt_cfg=None) -> DeviceProfile:
    """DeviceProfile from the cost models alone: the evidence's
    serve_decode roofline split into a weight-read floor and a
    per-stream slope, prefill priced by ``prefill_flops``. No card
    needed."""
    peaks = _peaks(device)
    sd = evidence["graphs"]["serve_decode"]
    slots = int(sd["config"]["slots"])
    flops = float(sd["cost_analysis"]["flops"])
    total_bytes = float(sd["cost_analysis"]["bytes_accessed"])
    kv = sd.get("kv_bytes_per_step", {})
    kv_typical = float(kv.get("typical_kv_bytes_per_step", 0.0))
    fixed_bytes = max(0.0, total_bytes - kv_typical)
    # the beat floor is the weight read no batch size amortizes away;
    # each extra active stream adds its FLOPs share and its KV reads
    base_ms = fixed_bytes / peaks["hbm_bytes_per_s"] * 1e3
    per_active_ms = max(flops / slots / peaks["flops_per_s"],
                        (kv_typical / slots) / peaks["hbm_bytes_per_s"]) \
        * 1e3
    prefill_ms = {b: prefill_flops(b, gpt_cfg) / peaks["flops_per_s"]
                  * 1e3 for b in buckets}
    return DeviceProfile(source=f"analytic-{device}",
                         beat_ms_base=base_ms,
                         beat_ms_per_active=per_active_ms,
                         prefill_ms=prefill_ms)


def publish_wire_ms(param_bytes: float, replicas: int) -> float:
    """Hot-swap weight-publish cost to a serve fleet over the
    between-node tier: one push per replica, serialized at the
    publisher's port (``FLAGS_topology_dcn_gbps``)."""
    from ..core import flags as _flags
    gbps = float(_flags.flag("FLAGS_topology_dcn_gbps"))
    return param_bytes * max(1, int(replicas)) / (gbps * 1e9) * 1e3


# ---------------------------------------------------------------------------
# queueing: closed forms
# ---------------------------------------------------------------------------

def _erlang_c(lam: float, mu: float, k: int) -> float:
    """P(wait) for M/M/k (Erlang C)."""
    a = lam / mu
    rho = a / k
    if rho >= 1.0:
        return 1.0
    s = sum(a ** n / math.factorial(n) for n in range(k))
    top = a ** k / math.factorial(k) / (1.0 - rho)
    return top / (s + top)


def queue_wait_ms(lam: float, service_s: float, scv: float,
                  k: int) -> float:
    """Allen–Cunneen M/G/k mean queue-wait approximation: the Erlang-C
    wait scaled by the service-time variability (1+scv)/2. The beat
    simulation is the primary TTFT predictor; this closed form is the
    sanity rail the report prints next to it (and diverges at the knee,
    which is the point)."""
    if lam <= 0 or service_s <= 0:
        return 0.0
    mu = 1.0 / service_s
    if lam / (k * mu) >= 1.0:
        return float("inf")
    pw = _erlang_c(lam, mu, k)
    wq = pw / (k * mu - lam)
    return wq * (1.0 + max(0.0, scv)) / 2.0 * 1e3


def knee_rps(profile: DeviceProfile, *, slots: int, mean_new: float,
             mean_prompt: float) -> float:
    """Saturation knee: at full batch one request holds a slot for
    E[n] beats while every admission serializes a prefill through the
    scheduler, so lambda_knee = slots / (E[n]*beat(slots) +
    slots*E[prefill])."""
    beat_s = profile.beat_ms(slots) / 1e3
    pf_s = (profile.prefill_cost_ms(int(round(mean_prompt)))
            + profile.admit_serial_ms) / 1e3
    return slots / max(1e-9, mean_new * beat_s + slots * pf_s)


# ---------------------------------------------------------------------------
# the beat simulation (deterministic discrete-event replay)
# ---------------------------------------------------------------------------

def _plus(x, dx):
    return None if x is None else round(x + dx, 3)


class _Req:
    __slots__ = ("ev", "t_arr", "total", "generated", "blocks",
                 "t_first", "preemptions", "decode_s")

    def __init__(self, ev, t_arr):
        self.ev = ev
        self.t_arr = t_arr
        self.total = ev.tokens_total()
        self.generated = 0
        self.blocks = 0
        self.t_first = None
        self.preemptions = 0
        self.decode_s = 0.0


def simulate(events, profile: DeviceProfile, *, slots: int,
             kv_blocks: int, block_size: int,
             time_scale: float = 1.0) -> Dict:
    """Replay a workload schedule through an analytic model of the
    ServeLoop scheduler beat: FCFS admission gated on a free slot AND
    worst-case block availability (`can_alloc(blocks_for(total))` —
    serving.py `_admit`), prefill serialized through the beat, one
    token per active stream per beat at `profile.beat_ms(active)`,
    block growth with preempt-on-exhaustion. Deterministic: same
    schedule + profile => same prediction."""
    bf = lambda n: max(1, -(-int(n) // int(block_size)))  # noqa: E731
    arrivals = sorted(events, key=lambda e: (e.t, e.index))
    n = len(arrivals)
    i = 0
    t = 0.0
    free = int(kv_blocks)
    queue: List[_Req] = []
    active: List[_Req] = []
    ttfts_ms: List[float] = []
    token_ms: List[float] = []
    retire_ts: List[float] = []
    completed = preempted = backpressure = 0

    def pull(now):
        nonlocal i
        while i < n and arrivals[i].t * time_scale <= now + 1e-12:
            queue.append(_Req(arrivals[i], arrivals[i].t * time_scale))
            i += 1

    while i < n or queue or active:
        if not queue and not active:
            t = max(t, arrivals[i].t * time_scale)
        pull(t)
        # FCFS admission (head of queue only — the real gate)
        while queue and len(active) < slots:
            r = queue[0]
            plen = r.ev.prompt.size + r.generated
            if free < bf(r.total):
                backpressure += 1
                break
            queue.pop(0)
            r.blocks = bf(plen)
            free -= r.blocks
            t += (profile.prefill_cost_ms(plen)
                  + profile.admit_serial_ms) / 1e3
            if r.t_first is None:
                r.t_first = t          # prefill emits the first token
                r.generated = 1
            active.append(r)
        if active:
            beat_s = profile.beat_ms(len(active)) / 1e3
            t += beat_s
            still = []
            for r in active:
                r.generated += 1
                # token gaps accrue decode beats only: the pipelined
                # driver overlaps admission prefills with decode settle,
                # so admission work delays QUEUED requests (TTFT), not
                # the active streams' token cadence
                r.decode_s += beat_s
                length = r.ev.prompt.size + r.generated
                need = bf(length)
                if need > r.blocks:
                    if free >= need - r.blocks:
                        free -= need - r.blocks
                        r.blocks = need
                    else:               # pool exhausted: preempt, requeue
                        free += r.blocks
                        r.blocks = 0
                        r.preemptions += 1
                        preempted += 1
                        queue.insert(0, r)
                        continue
                if r.generated >= r.ev.new_tokens:
                    free += r.blocks
                    completed += 1
                    retire_ts.append(t)
                    # admit_ms is latency-only: the arriving request
                    # feels the wakeup, the beat timeline does not
                    ttfts_ms.append((r.t_first - r.t_arr) * 1e3
                                    + profile.admit_ms)
                    if r.ev.new_tokens >= 2:
                        token_ms.append(r.decode_s * 1e3
                                        / (r.ev.new_tokens - 1))
                else:
                    still.append(r)
            active = still
        elif queue and i < n:
            # head blocked on the pool with nothing active can't happen
            # (empty pool ⇒ full free); blocked on slots ⇒ active nonempty
            t = arrivals[i].t * time_scale
    makespan = retire_ts[-1] if retire_ts else t
    return {"completed": completed, "preempted": preempted,
            "backpressure_ticks": backpressure,
            "makespan_s": round(makespan, 4),
            "ttfts_ms": ttfts_ms, "token_ms": token_ms}


def predict(spec, seed: int, profile: DeviceProfile, *, slots: int,
            kv_blocks: int, block_size: int,
            time_scale: float = 1.0) -> Dict:
    """The capacity prediction for one workload spec: beat-simulated
    TTFT/token p50/p99 + throughput, the closed-form knee, and the
    M/G/k wait rail. This dict is what `--validate` holds the hub's
    observations against."""
    from ..core.slo import percentile
    from ..traffic import workload as W

    events = W.schedule(spec, seed)
    sim = simulate(events, profile, slots=slots, kv_blocks=kv_blocks,
                   block_size=block_size, time_scale=time_scale)
    mean_new = float(np.mean([e.new_tokens for e in events])) \
        if events else 0.0
    mean_prompt = float(np.mean([e.prompt.size for e in events])) \
        if events else 0.0
    dur = max(1e-9, spec.duration_s * time_scale)
    offered = len(events) / dur
    knee = knee_rps(profile, slots=slots, mean_new=mean_new,
                    mean_prompt=mean_prompt)
    peak = W.arrival_peak_rate(spec.arrival) / max(1e-9, time_scale)
    # the M/G/k rail: service = one request's slot occupancy
    svc_s = ((profile.prefill_cost_ms(int(round(mean_prompt)))
              + profile.admit_serial_ms) / 1e3
             + mean_new * profile.beat_ms(slots) / 1e3)
    news = np.asarray([e.new_tokens for e in events], float)
    scv = float(news.var() / max(news.mean() ** 2, 1e-12)) \
        if len(news) else 0.0
    wait = queue_wait_ms(offered, svc_s, scv, max(1, int(slots)))
    return {
        "spec": spec.name, "seed": int(seed), "events": len(events),
        "profile": profile.source,
        "offered_rps": round(offered, 3),
        "peak_rps": round(peak, 3),
        "throughput_rps": round(sim["completed"]
                                / max(sim["makespan_s"], 1e-9), 3),
        "ttft_ms": {
            "p50": percentile(sim["ttfts_ms"], 50, ndigits=3),
            "p99": _plus(percentile(sim["ttfts_ms"], 99),
                         profile.ttft_tail_ms)},
        "token_ms": {
            "p50": percentile(sim["token_ms"], 50, ndigits=3),
            "p99": _plus(percentile(sim["token_ms"], 99),
                         profile.token_tail_ms)},
        "knee_rps": round(knee, 3),
        "rho": round(offered / max(knee, 1e-9), 4),
        "peak_rho": round(peak / max(knee, 1e-9), 4),
        "mgk_wait_ms": (None if wait == float("inf")
                        else round(wait, 3)),
        "completed": sim["completed"],
        "preempted": sim["preempted"],
        "backpressure_ticks": sim["backpressure_ticks"],
        "makespan_s": sim["makespan_s"],
    }
