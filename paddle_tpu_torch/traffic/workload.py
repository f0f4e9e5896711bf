"""Deterministic workload generator (paddle_tpu/traffic/workload.py,
whole): what millions of users look like, as a replayable event schedule.

A `WorkloadSpec` names an arrival process (steady Poisson, diurnal
wave, flash crowd, or explicit piecewise-rate windows — zero-rate
windows included), a tenant mix, and per-tenant heavy-tailed prompt /
generation-length samplers (LLM generate streams, or hybrid sessions
that pair recsys embedding lookups with a generate call). A
`WorkloadGenerator` turns (spec, seed) into a stream of `Event`s.

Determinism contract (the splitmix64 idiom of the JAX package's
distributed/ps/table.py): EVERY random draw comes from a named
splitmix64 stream keyed by `(seed, stream, index)` — counter-based,
never stateful. Two runs of the same (spec, seed) are byte-identical
(`schedule_digest`), draws are independent of Python iteration order,
and a generator resumed from `state_dict()` mid-wave emits exactly the
events the uninterrupted run would have. Wall clocks and stateful RNGs
(`time.time()`, `random.*`, bare `numpy.random`) are not used here;
the module is pure Python and numpy, the port's own copy.

Event times are in *schedule seconds* from t=0; the harness maps them
onto the wall clock (`PADDLE_TRAFFIC_TIME_SCALE`).
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["Stream", "WorkloadSpec", "WorkloadGenerator", "Event",
           "schedule", "schedule_digest", "builtin_spec", "BUILTIN_SPECS"]

_MASK64 = (1 << 64) - 1
_NORMAL_XOR = 0xD6E8FEB86659FD93  # second stream for Box-Muller


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


class Stream:
    """One named draw stream. `u01(i)` is a pure function of
    (seed, name, i): the i-th draw exists without drawing the first
    i-1, which is what makes schedules replayable and resumable."""

    __slots__ = ("key",)

    def __init__(self, seed: int, name: str):
        k = _splitmix64(int(seed) & _MASK64)
        for ch in name.encode("utf-8"):
            k = _splitmix64(k ^ ch)
        self.key = k

    def bits(self, index: int) -> int:
        return _splitmix64(self.key ^ _splitmix64(int(index) & _MASK64))

    def u01(self, index: int) -> float:
        """Uniform [0, 1) from the top 53 bits (table.py idiom)."""
        return (self.bits(index) >> 11) * (1.0 / (1 << 53))

    def normal(self, index: int) -> float:
        """Standard normal via Box-Muller over two decorrelated draws."""
        h = self.bits(index)
        u1 = max((h >> 11) * (1.0 / (1 << 53)), 1e-12)
        u2 = (_splitmix64(h ^ _NORMAL_XOR) >> 11) * (1.0 / (1 << 53))
        return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)

    def randint(self, index: int, lo: int, hi: int) -> int:
        """Integer in [lo, hi) — hi exclusive, like np.random.randint."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return lo
        return lo + int(self.u01(index) * (hi - lo))

    def exp(self, index: int, rate: float) -> float:
        """Exponential inter-arrival draw with the given rate."""
        return -math.log(max(1.0 - self.u01(index), 1e-300)) / float(rate)


# ---------------------------------------------------------------------------
# spec grammar (docs/traffic_lab.md)
# ---------------------------------------------------------------------------

# length-sampler grammar: {"kind": ..., **params}, truncated to
# [lo, min(hi, cap)] at draw time; truncations are counted in
# generator.stats["truncated"].
#   fixed:     {"kind": "fixed", "value": n}
#   uniform:   {"kind": "uniform", "lo": a, "hi": b}       (inclusive)
#   lognormal: {"kind": "lognormal", "median": m, "sigma": s, "lo", "hi"}
#   pareto:    {"kind": "pareto", "alpha": a, "scale": xm, "lo", "hi"}

def _sample_len(dist: Dict, stream: Stream, index: int, cap: int):
    """Returns (length, truncated)."""
    kind = dist.get("kind", "fixed")
    lo = int(dist.get("lo", 1))
    hi = min(int(dist.get("hi", cap)), int(cap))
    if kind == "fixed":
        raw = float(dist["value"])
    elif kind == "uniform":
        raw = float(stream.randint(index, lo, hi + 1))
    elif kind == "lognormal":
        mu = math.log(max(float(dist.get("median", 8)), 1e-9))
        raw = math.exp(mu + float(dist.get("sigma", 0.6))
                       * stream.normal(index))
    elif kind == "pareto":
        alpha = max(float(dist.get("alpha", 2.0)), 1e-6)
        xm = max(float(dist.get("scale", lo)), 1e-9)
        raw = xm / max(1.0 - stream.u01(index), 1e-12) ** (1.0 / alpha)
    else:
        raise ValueError(f"unknown length sampler kind {kind!r}")
    n = int(round(raw))
    truncated = n > hi
    return max(lo, min(n, hi)), truncated


# arrival grammar: {"kind": ..., **params}; rate(t) in requests/s.
#   poisson: {"kind": "poisson", "rate": r}
#   diurnal: {"kind": "diurnal", "base": b, "peak": p, "period_s": T}
#            rate(t) = b + (p-b) * (1 - cos(2*pi*t/T)) / 2
#   flash:   {"kind": "flash", "base": b, "burst_rate": r,
#             "burst_at_s": t0, "burst_len_s": d}
#   windows: {"kind": "windows", "windows": [[dur_s, rate], ...]}
#            piecewise-constant; rate 0 windows emit nothing.

def arrival_rate(arrival: Dict, t: float) -> float:
    kind = arrival.get("kind", "poisson")
    if kind == "poisson":
        return float(arrival["rate"])
    if kind == "diurnal":
        base = float(arrival.get("base", 0.0))
        peak = float(arrival["peak"])
        period = max(float(arrival.get("period_s", 60.0)), 1e-9)
        return base + (peak - base) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * t / period))
    if kind == "flash":
        t0 = float(arrival.get("burst_at_s", 0.0))
        if t0 <= t < t0 + float(arrival.get("burst_len_s", 1.0)):
            return float(arrival["burst_rate"])
        return float(arrival.get("base", 0.0))
    if kind == "windows":
        edge = 0.0
        for dur, rate in arrival["windows"]:
            edge += float(dur)
            if t < edge:
                return float(rate)
        return 0.0
    raise ValueError(f"unknown arrival kind {kind!r}")


def arrival_peak_rate(arrival: Dict) -> float:
    kind = arrival.get("kind", "poisson")
    if kind == "poisson":
        return float(arrival["rate"])
    if kind == "diurnal":
        return max(float(arrival.get("base", 0.0)), float(arrival["peak"]))
    if kind == "flash":
        return max(float(arrival.get("base", 0.0)),
                   float(arrival["burst_rate"]))
    if kind == "windows":
        return max([float(r) for _, r in arrival["windows"]] or [0.0])
    raise ValueError(f"unknown arrival kind {kind!r}")


_DEFAULT_TENANT = {
    "name": "default", "weight": 1.0, "kind": "llm",
    "prompt": {"kind": "lognormal", "median": 8, "sigma": 0.5, "lo": 2},
    "new": {"kind": "fixed", "value": 8},
}


@dataclass(frozen=True)
class WorkloadSpec:
    """One deterministic workload: arrival process x tenant mix x
    length samplers, bounded by (duration_s, max_events)."""

    name: str
    arrival: Dict
    duration_s: float
    tenants: Tuple[Dict, ...] = ()
    vocab: int = 1024
    max_seq_len: int = 64
    max_events: int = 100_000

    def resolved_tenants(self) -> List[Dict]:
        return [dict(t) for t in (self.tenants or (_DEFAULT_TENANT,))]

    def canonical(self) -> Dict:
        return {"name": self.name, "arrival": self.arrival,
                "duration_s": self.duration_s,
                "tenants": self.resolved_tenants(),
                "vocab": self.vocab, "max_seq_len": self.max_seq_len,
                "max_events": self.max_events}

    def digest(self) -> str:
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass
class Event:
    """One scheduled request. `t` is schedule seconds from start."""

    index: int
    t: float
    tenant: str
    kind: str                       # "llm" | "hybrid"
    prompt: np.ndarray              # int64 token ids, len >= 1
    new_tokens: int
    lookup_ids: Optional[np.ndarray] = None   # hybrid recsys pulls
    session: int = 0

    def tokens_total(self) -> int:
        return int(self.prompt.size) + int(self.new_tokens)


# events encode prompt token ids as sub-draws of one stream: event k,
# position j keys index (k << _SUBSHIFT) | j, so a schedule prefix
# never depends on how many tokens later events drew
_SUBSHIFT = 20


class WorkloadGenerator:
    """Iterator of `Event`s for (spec, seed). Resumable: `state_dict()`
    mid-iteration captures the exact position; a fresh generator given
    `load_state_dict(state)` continues byte-identically."""

    def __init__(self, spec: WorkloadSpec, seed: int = 0):
        if spec.max_seq_len < 4:
            raise ValueError("max_seq_len must be >= 4")
        self.spec = spec
        self.seed = int(seed)
        self.tenants = spec.resolved_tenants()
        w = [max(float(t.get("weight", 1.0)), 0.0) for t in self.tenants]
        tot = sum(w) or 1.0
        self._cum_weights = np.cumsum([x / tot for x in w])
        s = lambda name: Stream(self.seed, f"{spec.name}/{name}")  # noqa: E731
        self._arrive = s("arrival")
        self._thin = s("thin")
        self._tenant = s("tenant")
        self._plen = s("prompt_len")
        self._nlen = s("gen_len")
        self._ptok = s("prompt_tok")
        self._lookup = s("lookup")
        self._t = 0.0
        self._proposals = 0
        self._emitted = 0
        self.stats = {"events": 0, "truncated": 0, "by_tenant": {}}

    # -- resume contract -----------------------------------------------------
    def state_dict(self) -> Dict:
        return {"spec_digest": self.spec.digest(), "seed": self.seed,
                "t": self._t, "proposals": self._proposals,
                "emitted": self._emitted,
                "stats": json.loads(json.dumps(self.stats))}

    def load_state_dict(self, state: Dict) -> "WorkloadGenerator":
        if state.get("spec_digest") != self.spec.digest():
            raise ValueError("state_dict is for a different WorkloadSpec")
        if int(state.get("seed", -1)) != self.seed:
            raise ValueError("state_dict is for a different seed")
        self._t = float(state["t"])
        self._proposals = int(state["proposals"])
        self._emitted = int(state["emitted"])
        self.stats = json.loads(json.dumps(state["stats"]))
        return self

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator[Event]:
        while True:
            ev = self.next_event()
            if ev is None:
                return
            yield ev

    def next_event(self) -> Optional[Event]:
        """Thinning (Lewis-Shedler) over the time-varying rate: propose
        at the spec's peak rate, accept with prob rate(t)/peak — which
        makes zero-rate windows emit nothing while keeping every draw
        counter-keyed."""
        spec = self.spec
        peak = arrival_peak_rate(spec.arrival)
        if peak <= 0.0:
            return None
        while True:
            if self._emitted >= spec.max_events:
                return None
            i = self._proposals
            self._proposals += 1
            self._t += self._arrive.exp(i, peak)
            if self._t >= spec.duration_s:
                return None
            lam = arrival_rate(spec.arrival, self._t)
            if lam <= 0.0 or self._thin.u01(i) * peak >= lam:
                continue
            return self._emit(self._t)

    def _emit(self, t: float) -> Event:
        spec = self.spec
        k = self._emitted
        self._emitted += 1
        ti = int(np.searchsorted(self._cum_weights,
                                 self._tenant.u01(k), side="right"))
        tenant = self.tenants[min(ti, len(self.tenants) - 1)]
        cap = spec.max_seq_len - 1
        plen, p_trunc = _sample_len(
            tenant.get("prompt", _DEFAULT_TENANT["prompt"]),
            self._plen, k, cap)
        n_cap = spec.max_seq_len - plen
        nlen, n_trunc = _sample_len(
            tenant.get("new", _DEFAULT_TENANT["new"]),
            self._nlen, k, n_cap)
        base = k << _SUBSHIFT
        prompt = np.fromiter(
            (self._ptok.randint(base | j, 1, spec.vocab)
             for j in range(plen)), np.int64, count=plen)
        lookups = None
        if tenant.get("kind", "llm") == "hybrid":
            n_look = int(tenant.get("lookups", 8))
            lvocab = int(tenant.get("lookup_vocab", 100_000))
            lookups = np.fromiter(
                (self._lookup.randint(base | j, 0, lvocab)
                 for j in range(n_look)), np.int64, count=n_look)
        self.stats["events"] += 1
        self.stats["truncated"] += int(p_trunc) + int(n_trunc)
        name = tenant.get("name", "default")
        self.stats["by_tenant"][name] = \
            self.stats["by_tenant"].get(name, 0) + 1
        return Event(index=k, t=float(t), tenant=name,
                     kind=tenant.get("kind", "llm"), prompt=prompt,
                     new_tokens=int(nlen), lookup_ids=lookups, session=k)


def schedule(spec: WorkloadSpec, seed: int = 0) -> List[Event]:
    """The full replayable event schedule for (spec, seed)."""
    return list(WorkloadGenerator(spec, seed))


def schedule_digest(events) -> str:
    """SHA-256 over the canonical byte encoding of a schedule — the
    byte-identity oracle the replay tests assert on."""
    h = hashlib.sha256()
    for e in events:
        h.update(f"{e.index}|{e.t!r}|{e.tenant}|{e.kind}|"
                 f"{e.new_tokens}|".encode())
        h.update(np.ascontiguousarray(e.prompt, np.int64).tobytes())
        if e.lookup_ids is not None:
            h.update(b"|L|")
            h.update(np.ascontiguousarray(e.lookup_ids,
                                          np.int64).tobytes())
        h.update(b"\n")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# canonical specs: the capacity-validation trio (CPU tiny-model shape)
# ---------------------------------------------------------------------------

def _tiny_tenants() -> Tuple[Dict, ...]:
    return (
        {"name": "chat", "weight": 0.7, "kind": "llm",
         "prompt": {"kind": "lognormal", "median": 6, "sigma": 0.45,
                    "lo": 2, "hi": 16},
         "new": {"kind": "uniform", "lo": 4, "hi": 8}},
        {"name": "recsys", "weight": 0.3, "kind": "hybrid", "lookups": 8,
         "lookup_vocab": 65_536,
         "prompt": {"kind": "lognormal", "median": 5, "sigma": 0.35,
                    "lo": 2, "hi": 12},
         "new": {"kind": "fixed", "value": 4}},
    )


def builtin_spec(name: str, *, rate: float = 30.0,
                 duration_s: float = 6.0) -> WorkloadSpec:
    """The named validation workloads (`steady`, `diurnal`, `flash`):
    same tenant mix and samplers, three arrival shapes. `rate` is the
    mean offered load in requests/s."""
    if name == "steady":
        arrival = {"kind": "poisson", "rate": rate}
    elif name == "diurnal":
        # mean of base + (peak-base)/2 == rate
        arrival = {"kind": "diurnal", "base": rate * 0.4,
                   "peak": rate * 1.6, "period_s": duration_s}
    elif name == "flash":
        # quiet base with a 4x burst over the middle fifth of the run
        base = rate * 0.625
        arrival = {"kind": "flash", "base": base, "burst_rate": base * 4,
                   "burst_at_s": duration_s * 0.4,
                   "burst_len_s": duration_s * 0.2}
    else:
        raise ValueError(f"unknown builtin spec {name!r} "
                         "(steady|diurnal|flash)")
    return WorkloadSpec(name=name, arrival=arrival, duration_s=duration_s,
                        tenants=_tiny_tenants(), vocab=1024,
                        max_seq_len=48)


BUILTIN_SPECS = ("steady", "diurnal", "flash")
