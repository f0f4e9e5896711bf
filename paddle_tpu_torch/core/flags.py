"""Flag registry — the subset of paddle_tpu/core/flags.py the serving
and training slices read.

Flags are declared once with a type and default, seeded from a
same-named ``FLAGS_*`` environment variable at import, and get/set-able
at run time with ``set_flags``.

Of the JAX package's flash-attention flags, ``FLAGS_use_flash_attention``
and ``FLAGS_flash_min_seq`` are here; the min-seq default is the H100's
own (``chip_smoke.py``'s sweep), not the TPU's 1024. Left out:
``FLAGS_flash_block_q/k`` (TPU tile overrides; the CUDA kernels choose
their tiles themselves: csrc/flash_attention.cu from shared memory, the
Hopper kernels from ops/cuda/flash_attention.py's SM90_* constants) and
``FLAGS_flash_attention_interpret`` (there is no interpreter: CPU tensors
take the plain version, CUDA tensors the kernel).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "flag"]

_LOCK = threading.Lock()
_REGISTRY: Dict[str, Any] = {}
_DEFS: Dict[str, tuple] = {}  # name -> (type, default, help)


def define_flag(name: str, default, help_str: str = ""):
    ftype = type(default)
    with _LOCK:
        _DEFS[name] = (ftype, default, help_str)
        env = os.environ.get(name)
        _REGISTRY[name] = default if env is None else _parse(ftype, env)


def _parse(ftype, text: str):
    if ftype is bool:
        return text.strip().lower() in ("1", "true", "yes", "on")
    return ftype(text)


def set_flags(flags: Dict[str, Any]):
    with _LOCK:
        for name, value in flags.items():
            if name not in _DEFS:
                raise KeyError(f"unknown flag {name!r}")
            ftype = _DEFS[name][0]
            _REGISTRY[name] = _parse(ftype, value) \
                if isinstance(value, str) and ftype is not str \
                else ftype(value)


def get_flags(flags):
    """{name: value} of a flag name or a list of them."""
    if isinstance(flags, str):
        flags = [flags]
    with _LOCK:
        return {name: _REGISTRY[name] for name in flags}


def flag(name: str):
    """Fast internal accessor."""
    return _REGISTRY[name]


define_flag("FLAGS_serve_block_size", 0,
            "tokens per physical KV-pool block (nn/kv_pool.KVBlockPool); "
            "0 = auto: the 128-column heuristic clamped to the sequence "
            "budget. Must be a multiple of 8")
define_flag("FLAGS_serve_kv_blocks", 512,
            "physical blocks in the serving KV pool (per layer, k+v "
            "arenas); waiting requests stay queued until retiring streams "
            "free enough blocks")
define_flag("FLAGS_serve_max_active", 64,
            "decode slots in the serving batch: the fused decode step "
            "advances this many concurrent streams")
define_flag("FLAGS_executor_max_inflight", 2,
            "pipeline depth: how many dispatched-but-not-materialized "
            "steps the serve loop, the static PipelineRunner "
            "(train_from_dataset) and Model.fit keep queued on the device "
            "stream; 0 makes train_from_dataset run its synchronous loop")
define_flag("FLAGS_executor_scan_steps", 0,
            "scan-fused megasteps: when > 1 and the feed shapes are "
            "stable, the PipelineRunner stacks K batches on the host, "
            "copies them to the device at once and replays the K steps back "
            "to back with no host sync between them, bitwise equal to the "
            "serial loop (the per-step lr, step and seed stream is drawn "
            "as the serial loop draws it). 0/1 disables fusion")
define_flag("FLAGS_executor_cache_size", 32,
            "LRU bound on the static Executor's prepared replays (one per "
            "program version, feed-shape set and fetch list); an eviction "
            "bumps executor/cache_evictions")
define_flag("FLAGS_log_memory_estimate", False,
            "on each Executor preparation, publish static/shape_infer's "
            "liveness peak-memory estimate as the gauge "
            "executor/estimated_peak_bytes")
define_flag("FLAGS_use_flash_attention", True,
            "route scaled_dot_product_attention through the flash "
            "kernels (ops/cuda/flash_attention.py) where the gate admits "
            "the call; off = the attention composite")
define_flag("FLAGS_flash_min_seq", 128,
            "dispatch threshold: the flash kernels engage when s_k >= "
            "this. chip_smoke.py's sweep on the H100 found the kernels "
            "faster than the composite at every s it tried (128 to 4096, "
            "causal and not), so this is its smallest; below it the "
            "composite runs. 0 forces the kernels on whenever shapes allow")
define_flag("FLAGS_use_decode_attention", True,
            "route StaticKVCache attention outside training through the "
            "contiguous decode kernel (ops/cuda/decode_attention.py); "
            "off = the plain cache attention")
define_flag("FLAGS_use_fused_ce", True,
            "route linear+cross-entropy loss heads through the fused CE "
            "kernels (ops/cuda/fused_ce.py); off = the plain composite "
            "that materializes the logits")
define_flag("FLAGS_check_nan_inf", False,
            "check for inf / nan (core/numeric_check.py): every eager op's "
            "floating outputs after its kernel, naming the op; every "
            "Executor.run step's fetches and new scope, every hapi training "
            "step's loss and parameters and every PipelineRunner sync's "
            "carry before they are written back. Each check syncs")
define_flag("FLAGS_trace_ring_size", 4096,
            "bounded ring of recent finished spans kept by the always-on "
            "tracer (core/trace.py); 0 = unbounded. A runtime change "
            "applies at the next trace.start()/reset(), or at once through "
            "trace.set_ring_size()")
define_flag("FLAGS_monitor_series_len", 256,
            "per-metric bounded time-series ring in core/monitor: every "
            "stat_add/stat_set/observe appends (unix_ts, value)")
define_flag("PADDLE_STREAM_QUEUE_CAP", 1024,
            "bounded-queue capacity of dataset/streaming.StreamingDataset: "
            "producers (ServeLoop completion hooks) block in offer() once "
            "this many undelivered records are buffered")
define_flag("PADDLE_STREAM_DEDUPE_WINDOW", 4096,
            "record-id dedupe window of StreamingDataset: the ids of the "
            "last N accepted records are remembered and re-offers of any "
            "of them are rejected; the window rides state_dict()")
define_flag("PADDLE_CKPT_VERIFY", True,
            "verify every restored checkpoint step against its sha256 "
            "manifest (incubate/checkpoint.py); a mismatch quarantines "
            "the step and the restore walks back")
define_flag("PADDLE_TRAFFIC_SEED", 0,
            "base seed for the traffic lab's named splitmix64 draw "
            "streams (traffic/workload.py); two runs of the same spec "
            "with the same seed are byte-identical, schedule and "
            "per-request token draws")
define_flag("PADDLE_TRAFFIC_TIME_SCALE", 1.0,
            "wall-clock multiplier the harness paces a workload schedule "
            "with (traffic/harness.run_spec): 1.0 replays the spec in real "
            "time, 0.5 compresses it 2x, 2.0 stretches it")
define_flag("PADDLE_TRAFFIC_CLIENTS", 4,
            "number of submitter threads the traffic harness partitions a "
            "schedule across (round-robin by event index)")
define_flag("FLAGS_pallas_autotune", True,
            "block-size autotuning of the CUDA kernels (ops/cuda/"
            "autotune.py): measure the candidates at each new (kernel, "
            "shape bucket, dtype, device name) key and keep the winner, in "
            "process and, when PADDLE_TPU_CUDA_AUTOTUNE_CACHE names a json "
            "file, on disk. Measuring happens only for a CUDA device; "
            "elsewhere the heuristic default is used. FLAGS_serve_block_size "
            "wins over the table")
define_flag("FLAGS_pallas_autotune_force", False,
            "measure autotune candidates off the card too (tests exercise "
            "the measuring path with a fake measure)")
