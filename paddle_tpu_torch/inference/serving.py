"""Continuous-batching decode serving (paddle_tpu/inference/serving.py).

- **paged KV pool** (nn/kv_pool.py): all in-flight requests share one
  physical block arena per layer; per-request block tables make ragged
  lengths free, and a retiring request returns its blocks at once;
- **prefill/decode split with admission**: a request is admitted when a
  slot AND the blocks for its whole worst case are free, prefilled as a
  single-request pass padded to a power-of-two bucket (logits read at the
  real last prompt token), then joins the ONE fused decode batch that
  advances every active stream one token per step through the
  block-table CUDA kernel;
- **pipelining**: decode steps go through ``InflightDriver``
  (static/pipeline_runner.py). Step N's next tokens stay on the device
  and feed step N+1 directly, so the host dispatches step N+1 before it
  reads step N's tokens;
- **backpressure + preemption**: when the pool is exhausted admissions
  queue (FCFS); when an active stream cannot grow into a new block, the
  youngest active stream is evicted and re-queued with its generated
  prefix, so the oldest stream always completes.

Sampling draws the token at absolute position p of a request from
``position_seed(seed, p)`` (core/rng.py), so a stream's tokens do not
depend on its batch or on preemption. Greedy continuous-batched decode
gives the tokens of sequential ``GPT.generate``.

Every request that finishes emits a completion record through
``on_complete``; ``publish_weights`` stages a versioned weight swap that
applies between decode beats once every in-flight stream has retired.

Observability: spans ``serve/{admit,prefill,decode_step,retire,evict,
hot_swap}`` with a per-request flow chain, gauges ``serve.{queue_depth,
active_slots,kv_pool_used_blocks,kv_pool_free_blocks,model_version}``,
counters ``serve.{preempted,tokens_generated,requests_completed,
requests_errored,hot_swaps,completion_log_errors,backpressure_waits}``,
histograms ``serve/ttft_ms`` and ``serve/token_ms``. Each scheduler beat
consults the fault seam (``distributed/ps/rpc._fault("serve", "beat",
"tick")``): a scripted STALL delays the beat, a RESET is absorbed. A
kernel that fails on the card raises; there is no demotion to a plain
version.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..core import monitor as _monitor
from ..core import trace as _trace
from ..core.rng import sample_tokens
from ..distributed.ps.rpc import _fault
from ..nn.kv_pool import KVBlockPool, PagedKVCache, pick_block_size
from ..static.pipeline_runner import (FLOW_NS, InflightDriver,
                                      PipelineStepError)

__all__ = ["ServeConfig", "ServeRequest", "ServeLoop", "build_decode_step"]

# the serve.* gauges and counters this loop publishes (core/monitor);
# tools/obs_report.py's serving section renders them
GAUGES = ("serve.queue_depth", "serve.active_slots",
          "serve.kv_pool_used_blocks", "serve.kv_pool_free_blocks",
          "serve.model_version")
COUNTERS = ("serve.preempted", "serve.tokens_generated",
            "serve.requests_completed", "serve.requests_errored",
            "serve.hot_swaps", "serve.completion_log_errors",
            "serve.backpressure_waits")

_REQ_IDS = itertools.count()


@dataclass
class ServeConfig:
    """Knobs for one ServeLoop. Zeros mean "take the FLAGS_serve_*
    default" (core/flags.py)."""

    max_active: int = 0     # decode slots (FLAGS_serve_max_active)
    kv_blocks: int = 0      # pool blocks (FLAGS_serve_kv_blocks)
    block_size: int = 0     # tokens/block (FLAGS_serve_block_size / auto)
    max_seq_len: int = 0    # per-request cap (0 = model max_seq_len)
    temperature: float = 0.0
    top_k: int = None
    eos_token_id: int = None   # default; per-request override wins
    max_inflight: int = 0      # decode pipeline depth (0 = executor flag)

    def resolve(self, net):
        from ..core import flags as _flags
        cfg = net.config
        max_active = int(self.max_active
                         or _flags.flag("FLAGS_serve_max_active"))
        kv_blocks = int(self.kv_blocks
                        or _flags.flag("FLAGS_serve_kv_blocks"))
        max_seq = min(int(self.max_seq_len or cfg.max_seq_len),
                      cfg.max_seq_len)
        block_size = int(self.block_size or pick_block_size(
            max_seq, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
            net.dtype, max_active, device=net.device))
        max_inflight = int(self.max_inflight
                           or _flags.flag("FLAGS_executor_max_inflight"))
        return max_active, kv_blocks, block_size, max_seq, \
            max(1, max_inflight)


class ServeRequest:
    """One generate stream. Clients hold it as a future: ``result()``
    blocks until the stream finishes (or raises its error)."""

    def __init__(self, prompt, max_new_tokens, eos_token_id, seed):
        self.rid = next(_REQ_IDS)
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.eos_token_id = eos_token_id
        self.seed = int(seed)
        self.out = []            # generated token ids (host ints)
        self.error = None
        self.preemptions = 0
        self.snapshot_version = None  # model version pinned at 1st admit
        self.t_submit = time.perf_counter()
        self.t_first = None      # first generated token materialized
        self.t_done = None
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight")
        return self

    def result(self, timeout=None):
        """Generated tokens [n] (prompt excluded); raises the request's
        error if serving failed it."""
        self.wait(timeout)
        if self.error is not None:
            raise self.error
        return np.asarray(self.out, np.int64)

    @property
    def ttft_s(self):
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def per_token_s(self):
        if self.t_done is None or self.t_first is None or len(self.out) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.out) - 1)

    def completion_record(self):
        """Retire-time record of host ints and floats only."""
        return {
            "rid": int(self.rid),
            "prompt": [int(t) for t in self.prompt.tolist()],
            "tokens": [int(t) for t in self.out],
            "version": self.snapshot_version,
            "preemptions": int(self.preemptions),
            "t_submit": self.t_submit,
            "t_first": self.t_first,
            "t_done": self.t_done,
            "ttft_s": self.ttft_s,
            "per_token_s": self.per_token_s,
        }


def build_decode_step(net, temperature=0.0, top_k=None):
    """The fused decode step: every slot advances one token.
    (arenas, block_tables, lengths, tokens, seeds, positions) ->
    next_tokens [A]. The arenas are written in place; ``seeds`` and
    ``positions`` are host ints for sampling."""

    @torch.no_grad()
    def decode_step(arenas, block_tables, lengths, tokens, seeds,
                    positions):
        caches = [PagedKVCache(k, v, block_tables, lengths)
                  for (k, v) in arenas]
        logits, _ = net._forward_paged(tokens[:, None], caches)
        return sample_tokens(logits, temperature, top_k, seeds, positions)

    return decode_step


def _build_prefill(net, temperature, top_k):
    """The bucketed prefill of one request: its padded prompt writes k/v
    into its pool blocks and samples the first token, which is also
    spliced into a copy of the decode batch's token carry at ``slot``.
    (arenas, tokens, bt_row, ids, real_len, seed, slot) ->
    (new_tokens, first_token)."""

    @torch.no_grad()
    def prefill(arenas, tokens, bt_row, ids, real_len, seed, slot):
        lens = torch.zeros((1,), dtype=torch.int32, device=ids.device)
        caches = [PagedKVCache(k, v, bt_row, lens) for (k, v) in arenas]
        last = torch.full((1,), real_len - 1, dtype=torch.int64,
                          device=ids.device)
        logits, _ = net._forward_paged(ids, caches, last_index=last)
        first = sample_tokens(logits, temperature, top_k, [seed],
                              [real_len])[0]
        # a copy: the old carry may still be an in-flight step's fetch
        tokens = tokens.clone()
        tokens[slot] = first
        return tokens, first

    return prefill


def _to_device(arr, device):
    """Host array -> tensor on ``device`` without waiting on the stream:
    through pinned memory, asynchronously, on CUDA."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _Slot:
    __slots__ = ("req", "length", "blocks", "version", "admit_seq")

    def __init__(self, req, blocks, version, admit_seq):
        self.req = req
        self.length = 0          # tokens written into the cache
        self.blocks = blocks     # physical block ids (pool-owned)
        self.version = version
        self.admit_seq = admit_seq


class ServeLoop:
    """Continuous-batching server over one eval-mode GPT-style model, on
    the model's device.

    Batch use:  ``ServeLoop(net).serve(prompts)`` drives the caller
    thread. Server use: ``start()`` spawns the scheduler thread; any
    number of client threads ``submit(...).result()``; ``stop()`` drains
    and joins."""

    def __init__(self, net, config=None, on_complete=None, **overrides):
        self.net = net
        if overrides and config is not None:
            raise ValueError("pass either a ServeConfig or kwargs")
        self.config = config or ServeConfig(**overrides)
        (self._A, n_blocks, self._bs, self._cap,
         self._max_inflight) = self.config.resolve(net)
        if net.training:
            net.eval()  # decode kernels are eval-only; serving never drops
        self._device = net.device
        self._dtype = net.dtype
        self._pool = KVBlockPool(n_blocks, self._bs)
        self._MB = -(-self._cap // self._bs)     # block-table width
        self._arenas = self._new_arenas()
        self._tokens = torch.zeros((self._A,), dtype=torch.int64,
                                   device=self._device)
        self._driver = InflightDriver("serve",
                                      max_inflight=self._max_inflight)
        self._flow_base = next(FLOW_NS) << 42   # per-request flow chain
        self._step = build_decode_step(net, self.config.temperature,
                                       self.config.top_k)
        self._prefill = _build_prefill(net, self.config.temperature,
                                       self.config.top_k)
        self._slots = [None] * self._A
        self._queue: deque = deque()
        self._pending: deque = deque()  # settle entries, driver order
        self._on_complete = on_complete
        self.model_version = 0
        self._staged_swap = None         # (version, {name: tensor})
        self._version = 0
        self._admit_seq = 0
        self._step_count = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._thread = None
        self._stopping = False

    def _new_arenas(self):
        cfg = self.net.config
        return self._pool.arenas(cfg.num_layers, cfg.num_heads,
                                 cfg.hidden_size // cfg.num_heads,
                                 self._dtype, self._device)

    # -- public API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, eos_token_id=None, seed=0):
        """Enqueue one generate stream; returns its ServeRequest future.
        Thread-safe."""
        eos = self.config.eos_token_id if eos_token_id is None \
            else eos_token_id
        req = ServeRequest(prompt, max_new_tokens, eos, seed)
        total = req.prompt.size + req.max_new_tokens
        if total > self._cap:
            raise ValueError(
                f"request needs {total} tokens > serving cap {self._cap}")
        if self._pool.blocks_for(total) > self._pool.n_blocks:
            raise ValueError(
                f"request needs {self._pool.blocks_for(total)} blocks > "
                f"pool size {self._pool.n_blocks}")
        with self._work:
            self._queue.append(req)
            self._work.notify_all()
        return req

    def serve(self, prompts, **kw):
        """Submit every prompt, drive the scheduler on the caller thread
        until idle, return the generated-token arrays in order."""
        if self._thread is not None:
            raise RuntimeError("serve() on a started loop; use submit()")
        reqs = [self.submit(p, **kw) for p in prompts]
        self.run_until_idle()
        return [r.result(timeout=0) for r in reqs]

    def run_until_idle(self):
        while self._has_work():
            self._tick()
        self._drain()

    def start(self):
        """Run the scheduler on its own thread."""
        if self._thread is not None:
            return self
        self._stopping = False
        self._thread = threading.Thread(target=self._serve_forever,
                                        daemon=True, name="serve-loop")
        self._thread.start()
        return self

    def stop(self, timeout=30):
        """Finish in-flight and queued work, then stop the thread. Raises
        on timeout rather than orphan a running scheduler."""
        t = self._thread
        if t is None:
            return
        with self._work:
            self._stopping = True
            self._work.notify_all()
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(
                f"serve loop did not drain within {timeout}s "
                f"({self.stats()})")
        self._thread = None

    def stats(self):
        return {
            "queue_depth": len(self._queue),
            "active_slots": sum(s is not None for s in self._slots),
            "kv_pool_used_blocks": self._pool.used_blocks,
            "kv_pool_free_blocks": self._pool.free_blocks,
            "steps": self._step_count,
            "block_size": self._bs,
            "max_active": self._A,
            "model_version": self.model_version,
            "swap_staged": self._staged_swap is not None,
        }

    def publish_weights(self, version, updates):
        """Stage a versioned weight swap: ``updates`` maps parameter names
        (``net.named_parameters()``, torch layout) to replacement arrays.
        Validated (name + shape) here; applied by the scheduler between
        decode beats once every in-flight stream has retired. While a
        swap is staged admission pauses and queued requests wait. A
        second publish before the first applies replaces it.
        Thread-safe."""
        params = dict(self.net.named_parameters())
        staged = {}
        for name, arr in dict(updates).items():
            if name not in params:
                raise KeyError(f"unknown param {name!r}")
            t = torch.as_tensor(np.asarray(arr))
            want = tuple(params[name].shape)
            if tuple(t.shape) != want:
                raise ValueError(f"shape {tuple(t.shape)} for {name!r} "
                                 f"!= served {want}")
            staged[name] = t
        with self._work:
            self._staged_swap = (int(version), staged)
            self._work.notify_all()
        return self

    # -- scheduler ----------------------------------------------------------
    def _has_work(self):
        return bool(self._queue or self._pending
                    or self._staged_swap is not None
                    or any(s is not None for s in self._slots))

    def _serve_forever(self):
        while True:
            with self._work:
                while not self._has_work() and not self._stopping:
                    self._work.wait(timeout=0.05)
                if self._stopping and not self._has_work():
                    return
            self._tick()

    def _tick(self):
        """One scheduler beat: settle enough of the pipeline to bound the
        window, admit, grow/preempt, dispatch the next fused decode step
        (step N+1 overlapping the settle of step N)."""
        # testing/faults.py ("serve", "beat") boundary: a scripted STALL
        # here models a hung scheduler beat. Transport-shaped faults
        # (RESET) have no meaning at a beat and are absorbed.
        try:
            _fault("serve", "beat", "tick")
        except ConnectionError:
            pass
        while len(self._pending) >= self._max_inflight:
            self._settle_one()
        if self._staged_swap is not None:
            # drain barrier: no admission while a swap is staged
            if any(s is not None for s in self._slots):
                self._grow_or_preempt()
                self._dispatch_decode()
            elif self._pending:
                self._settle_one()
            else:
                self._apply_swap()
            self._publish_gauges()
            return
        self._admit()
        if any(s is not None for s in self._slots):
            self._grow_or_preempt()
            self._dispatch_decode()
        elif self._pending:
            self._settle_one()
        self._publish_gauges()

    def _drain(self):
        while self._pending:
            self._settle_one()
        self._publish_gauges()

    def _apply_swap(self):
        """The swap itself, between beats with nothing in flight. The KV
        pool is version-agnostic: only future passes read new weights."""
        version, updates = self._staged_swap
        self._staged_swap = None
        params = dict(self.net.named_parameters())
        with _trace.span("serve/hot_swap", version=version,
                         params=len(updates)):
            with torch.no_grad():
                for name, t in updates.items():
                    params[name].copy_(t.to(params[name].dtype))
            self.model_version = int(version)
            _monitor.stat_add("serve.hot_swaps")

    # -- admission / prefill -------------------------------------------------
    def _free_slot(self):
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _admit(self):
        while True:
            with self._lock:
                req = self._queue[0] if self._queue else None
            if req is None:
                return
            idx = self._free_slot()
            if idx is None:
                _monitor.stat_add("serve.backpressure_waits")
                return
            prompt = np.concatenate(
                [req.prompt, np.asarray(req.out, np.int64)]) \
                if req.out else req.prompt
            remaining = req.max_new_tokens - len(req.out)
            need_total = self._pool.blocks_for(prompt.size + remaining)
            # BACKPRESSURE: the head of the queue waits (FCFS) until
            # retiring streams free enough blocks for its worst case
            if not self._pool.can_alloc(need_total):
                _monitor.stat_add("serve.backpressure_waits")
                return
            with self._lock:
                self._queue.popleft()
            blocks = self._pool.alloc(self._pool.blocks_for(prompt.size))
            with _trace.span("serve/admit", req=req.rid, slot=idx,
                             prompt_len=int(prompt.size),
                             blocks=len(blocks)) as sp:
                sp.flow(self._flow_base + req.rid, "s")
                if req.snapshot_version is None:
                    req.snapshot_version = self.model_version
                self._version += 1
                self._admit_seq += 1
                slot = _Slot(req, blocks, self._version, self._admit_seq)
                self._slots[idx] = slot
                self._dispatch_prefill(idx, slot, prompt)

    @staticmethod
    def _bucket(n):
        """Power-of-two prefill length from 8, so prefill shapes repeat."""
        b = 8
        while b < n:
            b *= 2
        return b

    def _dispatch_prefill(self, idx, slot, prompt):
        req = slot.req
        s_real = int(prompt.size)
        bucket = self._bucket(s_real)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :s_real] = prompt
        bt_row = np.zeros((1, self._MB), np.int32)
        bt_row[0, :len(slot.blocks)] = slot.blocks
        with _trace.span("serve/prefill", req=req.rid, slot=idx,
                         prompt_len=s_real, bucket=bucket) as sp:
            sp.flow(self._flow_base + req.rid, "t")

            def thunk():
                tokens, first = self._prefill(
                    self._arenas, self._tokens,
                    _to_device(bt_row, self._device),
                    _to_device(ids, self._device), s_real, req.seed, idx)
                return tokens, [first]

            carry, handles = self._driver.submit(thunk, kind="prefill",
                                                 req=req.rid)
        if carry is not None:
            self._tokens = carry
        slot.length = s_real
        self._pending.append(("prefill", handles, req, idx, slot.version))

    # -- growth / preemption -------------------------------------------------
    def _youngest_active(self):
        best = None
        for i, s in enumerate(self._slots):
            if s is not None and (best is None or s.admit_seq
                                  > self._slots[best].admit_seq):
                best = i
        return best

    def _grow_or_preempt(self):
        """Every active slot writes its next token at position ``length``
        this step; make sure the covering block exists, evicting the
        youngest stream when the pool is dry (the oldest always wins)."""
        order = sorted((i for i, s in enumerate(self._slots)
                        if s is not None),
                       key=lambda i: self._slots[i].admit_seq)
        for idx in order:
            slot = self._slots[idx]
            if slot is None:          # evicted by an earlier iteration
                continue
            need_blk = slot.length // self._bs
            while need_blk >= len(slot.blocks):
                got = self._pool.alloc(1)
                if got is not None:
                    slot.blocks.extend(got)
                    continue
                victim = self._youngest_active()
                self._preempt(victim)
                if victim == idx:
                    break             # preempted ourselves; slot is gone

    def _preempt(self, idx):
        slot = self._slots[idx]
        req = slot.req
        with _trace.span("serve/evict", req=req.rid, slot=idx,
                         generated=len(req.out),
                         blocks=len(slot.blocks)) as sp:
            sp.flow(self._flow_base + req.rid, "t")
            self._pool.free(slot.blocks)
            self._slots[idx] = None
            req.preemptions += 1
            _monitor.stat_add("serve.preempted")
            with self._lock:
                # back to the head: it is older than everything queued,
                # and its re-prefill (prompt + generated prefix) replays
                # the same token stream
                self._queue.appendleft(req)

    # -- decode dispatch -----------------------------------------------------
    def _dispatch_decode(self):
        A, MB = self._A, self._MB
        lengths = np.zeros((A,), np.int32)
        bt = np.zeros((A, MB), np.int32)
        seeds = [0] * A
        positions = [0] * A
        snapshot = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            lengths[i] = s.length
            bt[i, :len(s.blocks)] = s.blocks
            seeds[i] = s.req.seed
            positions[i] = s.length + 1
            snapshot.append((i, s.req, s.version))
        step_idx = self._step_count
        self._step_count += 1
        with _trace.span("serve/decode_step", step=step_idx,
                         active=len(snapshot)):

            def thunk():
                nxt = self._step(self._arenas,
                                 _to_device(bt, self._device),
                                 _to_device(lengths, self._device),
                                 self._tokens, seeds, positions)
                return nxt, [nxt]

            carry, handles = self._driver.submit(thunk, kind="decode",
                                                 active=len(snapshot))
        if carry is not None:
            self._tokens = carry
        for i, _req, _ver in snapshot:
            self._slots[i].length += 1
        self._pending.append(("decode", handles, snapshot))

    # -- settlement / retirement --------------------------------------------
    def _settle_one(self):
        entry = self._pending.popleft()
        try:
            toks = np.asarray(entry[1][0])
        except PipelineStepError as exc:
            self._fail_inflight(exc)
            return
        now = time.perf_counter()
        if entry[0] == "prefill":
            _kind, _h, req, idx, version = entry
            slot = self._slots[idx]
            if slot is None or slot.version != version:
                return               # preempted before its first token
            self._append_token(idx, slot, int(toks), now, first=True)
            return
        _kind, _h, snapshot = entry
        for idx, req, version in snapshot:
            slot = self._slots[idx]
            if slot is None or slot.version != version \
                    or slot.req is not req:
                continue             # retired/preempted mid-flight
            self._append_token(idx, slot, int(toks[idx]), now)

    def _append_token(self, idx, slot, token, now, first=False):
        req = slot.req
        if first and req.t_first is None and not req.out:
            req.t_first = now
        req.out.append(token)
        _monitor.stat_add("serve.tokens_generated")
        if (req.eos_token_id is not None and token == req.eos_token_id) \
                or len(req.out) >= req.max_new_tokens:
            self._retire(idx, slot)

    def _retire(self, idx, slot):
        """Finished stream: free its blocks at once (they are the
        admission currency of whoever is queued) and complete the
        future. In-flight steps that still carry this slot are ignored at
        settle through the slot version."""
        req = slot.req
        with _trace.span("serve/retire", req=req.rid, slot=idx,
                         generated=len(req.out),
                         blocks=len(slot.blocks)) as sp:
            sp.flow(self._flow_base + req.rid, "f")
            self._pool.free(slot.blocks)
            self._slots[idx] = None
            req.t_done = time.perf_counter()
            _monitor.stat_add("serve.requests_completed")
            if req.ttft_s is not None:
                _monitor.observe("serve/ttft_ms", req.ttft_s * 1e3)
            if req.per_token_s is not None:
                _monitor.observe("serve/token_ms", req.per_token_s * 1e3)
            if self._on_complete is not None:
                # the record goes out BEFORE the future resolves; a hook
                # error never fails serving
                try:
                    self._on_complete(req.completion_record())
                except Exception:  # noqa: BLE001 — counted, never fatal
                    _monitor.stat_add("serve.completion_log_errors")
            req._done.set()

    def _fail_inflight(self, exc):
        """A step died on the device: fail every in-flight stream,
        rebuild the device state, keep serving the queue."""
        self._pending.clear()
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            slot.req.error = exc
            slot.req.t_done = time.perf_counter()
            slot.req._done.set()
            self._pool.free(slot.blocks)
            self._slots[i] = None
            _monitor.stat_add("serve.requests_errored")
        self._arenas = self._new_arenas()
        self._tokens = torch.zeros((self._A,), dtype=torch.int64,
                                   device=self._device)
        self._driver = InflightDriver("serve",
                                      max_inflight=self._max_inflight)

    # -- gauges --------------------------------------------------------------
    def _publish_gauges(self):
        _monitor.stat_set_many({
            "serve.queue_depth": len(self._queue),
            "serve.active_slots": sum(s is not None for s in self._slots),
            "serve.kv_pool_used_blocks": self._pool.used_blocks,
            "serve.kv_pool_free_blocks": self._pool.free_blocks,
            "serve.model_version": self.model_version,
        })
