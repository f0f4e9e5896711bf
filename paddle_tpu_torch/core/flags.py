"""Flag registry — the subset of paddle_tpu/core/flags.py the port
reads: serving, training, the parameter-server tier (``PADDLE_PS_*``),
online learning (``PADDLE_ONLINE_*``) and cluster telemetry
(``PADDLE_TELEMETRY_*``, ``PADDLE_SLO_*``).

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
define_flag("FLAGS_enable_profiler", False,
            "the host event profiler is on (profiler.start_profiler sets it, "
            "stop_profiler clears it): every eager op then records an "
            "op/<name> event")
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

# --- PS transport fault tolerance (distributed/ps/rpc.py) ---------------
# The reference's brpc channel exposes the same three knobs
# (connect_timeout_ms / timeout_ms / max_retry in brpc_ps_client.cc);
# flag names double as their env-var spelling, so a job script can export
# PADDLE_PS_CALL_TIMEOUT=5 without touching code.
define_flag("PADDLE_PS_CALL_TIMEOUT", 60.0,
            "per-RPC deadline in seconds; a call that stalls past it "
            "times out, retries, and finally raises DeadlineExceeded")
define_flag("PADDLE_PS_MAX_RETRIES", 5,
            "transport retry budget per call (attempts = retries + 1); "
            "mutating calls are made retry-safe by the server-side "
            "idempotent replay cache")
define_flag("PADDLE_PS_BACKOFF_BASE_S", 0.05,
            "first retry backoff in seconds; doubles per retry with "
            "jitter up to PADDLE_PS_BACKOFF_MAX_S")
define_flag("PADDLE_PS_BACKOFF_MAX_S", 2.0,
            "exponential backoff ceiling in seconds")
define_flag("PADDLE_PS_CONNECT_RETRY_S", 30.0,
            "initial-dial retry window: workers racing the server's bind "
            "at job start keep redialing this long before giving up")
define_flag("PADDLE_PS_MAX_FRAME", 1 << 30,
            "largest RPC frame either side will accept; a length prefix "
            "over this is rejected as a FrameError instead of an "
            "unbounded allocation from one garbled header")
define_flag("PADDLE_PS_REPLAY_CACHE", 512,
            "per-client entries in the server's idempotent-replay LRU; "
            "a retried mutating request inside this window replays the "
            "cached reply instead of re-applying the gradient")
define_flag("PADDLE_PS_SEND_RETRIES", 2,
            "extra Communicator send-thread attempts (with backoff) on "
            "top of the per-call transport retries before the thread "
            "declares itself dead")

# --- PS replicated storage tier (distributed/ps/{shard_map,replica}.py) --
define_flag("PADDLE_PS_REPLICA_BACKUPS", 0,
            "backups per shard when the fleet wiring builds the initial "
            "shard map (0 = replication off: the default map reproduces "
            "the legacy id%n_servers placement exactly). With k>0 every "
            "mutation is applied on the primary, forwarded to its "
            "backups under the SAME replay id, and acked only once "
            "durable on the write quorum")
define_flag("PADDLE_PS_REPLICA_QUORUM", 0,
            "replicas (primary included) that must ack a write before "
            "the client is acked; 0 = every LIVE replica (unreachable "
            "backups are evicted from the map rather than wedging "
            "writes)")
define_flag("PADDLE_PS_REPLICA_DELTA_LOG", 512,
            "per-table entries in the replay-keyed mutation log primaries "
            "keep for rejoin catch-up: a restarted server loads the "
            "snapshot, then replays the log suffix past its cursor; a "
            "cursor that fell off the bounded log restarts the fetch")
define_flag("PADDLE_PS_HEARTBEAT_S", 0.5,
            "replica heartbeat interval in seconds: every server beats "
            "replica_beat into its peers; beat replies gossip shard-map "
            "epochs so a behind server catches up")
define_flag("PADDLE_PS_HEARTBEAT_TIMEOUT_S", 3.0,
            "suspicion deadline: a primary whose beats stop for this "
            "long is declared dead and its first live backup promotes "
            "itself (shard-map epoch bump + broadcast)")
define_flag("PADDLE_PS_FAILOVER_RETRIES", 8,
            "extra client re-route attempts per logical call after a "
            "stale-map redirect or dead endpoint; paced by "
            "PADDLE_PS_FAILOVER_BACKOFF_S, the loop must outlast one "
            "heartbeat timeout + promotion")
define_flag("PADDLE_PS_FAILOVER_BACKOFF_S", 0.25,
            "base pause between client failover re-routes (grows "
            "linearly up to 4x)")

# --- sharded embedding engine (distributed/ps/{client,heter,embedding}.py) --
define_flag("PADDLE_PS_FANOUT_THREADS", 4,
            "per-shard fan-out concurrency of batched sparse lookups: a "
            "pull whose (deduped) ids span several shard primaries issues "
            "one RPC per shard from a pool of this many threads, so the "
            "batch costs max(shard latency), not the sum. 1 restores the "
            "serial per-shard loop (bitwise-identical results either way "
            "— shard slices are disjoint)")
define_flag("PADDLE_PS_PREFETCH_DEPTH", 2,
            "embedding-prefetch window depth (distributed/ps/embedding."
            "EmbeddingPrefetcher riding static/pipeline_runner."
            "InflightDriver): how many batches of sparse pulls may be in "
            "flight ahead of the training step. Results stay BITWISE "
            "equal to synchronous pulls: ids pushed after a batch's "
            "prefetch snapshot are re-pulled at materialization "
            "(conflict fix-up), so overlap never trades determinism")
define_flag("PADDLE_PS_HETER_CACHE_ROWS", 65536,
            "hot-id LRU bound on the HeterPS device-resident embedding "
            "cache (distributed/ps/heter.HeterPSCache): rows past the "
            "bound evict oldest-first into the host-RAM tier (see "
            "PADDLE_PS_HETER_HOST_ROWS), bumping ps.heter.evictions — "
            "device memory holds the hot working set, not the vocab")
define_flag("PADDLE_PS_HETER_HOST_ROWS", 262144,
            "host-RAM second tier of the HeterPS cache: rows evicted "
            "from the device LRU park here (HeterPS lineage — tables "
            "larger than device memory tier through host DRAM before "
            "the PS); a host hit re-promotes without a PS RPC "
            "(ps.heter.host_hits). 0 disables the tier (evictions go "
            "straight back to the PS)")

# --- online learning (static/executor.py online mode) ---
define_flag("PADDLE_ONLINE_SYNC_EVERY", 1,
            "flush cadence of the online (continuous Downpour) trainer "
            "mode in static/executor.py: accumulated sparse deltas are "
            "pushed to the PS via push_sparse_delta every this many "
            "batches — one replay-id-protected RPC per touched shard "
            "per flush")
define_flag("PADDLE_ONLINE_STALENESS_BATCHES", 4,
            "bounded-staleness knob of the online trainer: the hard "
            "bound on batches trained past the last SUCCESSFUL delta "
            "flush. A transiently failing flush (PS chaos, failover in "
            "progress) is retried next cadence until this bound, then "
            "the flush error propagates (fail-stop) rather than letting "
            "the served model fall arbitrarily behind")

# --- cluster telemetry plane (core/telemetry.py, core/slo.py,
# --- tools/cluster_obs_drill.py) ---
define_flag("PADDLE_TELEMETRY_HUB", "",
            "host:port of a TelemetryHub. When set, processes that opt "
            "in (drills, bench.py snapshot emitters, anything that "
            "starts a TelemetryShipper) ship metric deltas / span "
            "batches there; empty (the default) means fully local "
            "observability, no network")
define_flag("PADDLE_TELEMETRY_FLUSH_S", 0.5,
            "TelemetryShipper flush cadence: every this many seconds "
            "the background thread snapshots the monitor registry and "
            "ships one replay-keyed delta batch to the hub. The hot "
            "path only ever appends to an in-memory buffer — a slow or "
            "dead hub can delay shipping, never a decode beat")
define_flag("PADDLE_TELEMETRY_SPAN_BUFFER", 2048,
            "bound on the shipper's finished-span buffer. When the hub "
            "falls behind and the buffer is full, new spans are dropped "
            "on the floor and counted in telemetry.dropped_spans / "
            "telemetry.dropped_batches (backpressure by shedding, "
            "never by blocking the thread that finished the span)")
define_flag("PADDLE_TELEMETRY_INCIDENT_WINDOW_S", 10.0,
            "incident coalescing window of the TelemetryHub: flight-"
            "recorder triggers and SLO breaches arriving within this "
            "many seconds of an open incident JOIN it (one incident id, "
            "one merged dump) instead of opening a new one")
define_flag("PADDLE_SLO_EVAL_S", 1.0,
            "cadence of the hub's SLO engine: every this many seconds "
            "the merged counters/histograms are appended to the burn-"
            "rate series and every SLOSpec is re-evaluated")
define_flag("PADDLE_SLO_FAST_WINDOW_S", 60.0,
            "fast burn-rate window: a breach requires the bad fraction "
            "over BOTH this window and the slow window to exceed the "
            "objective — the fast window bounds time-to-detect, the "
            "slow window filters blips")
define_flag("PADDLE_SLO_SLOW_WINDOW_S", 300.0,
            "slow burn-rate window (see PADDLE_SLO_FAST_WINDOW_S); "
            "also bounds how much burn-rate history the engine retains "
            "per SLO spec (2x this window)")
define_flag("FLAGS_capacity_p50_band_pct", 25.0,
            "capacity_plan --validate error band: hub-observed "
            "throughput and TTFT/token p50 must land within this "
            "percentage of the model's prediction")
define_flag("FLAGS_capacity_p99_band_pct", 40.0,
            "capacity_plan --validate error band for the tail: "
            "hub-observed TTFT/token p99 within this percentage of the "
            "prediction (tails carry sampling noise the p50 band does "
            "not)")
define_flag("FLAGS_capacity_knee_rho", 0.85,
            "utilization the capacity report flags as the saturation "
            "knee: offered loads driving predicted slot utilization "
            "above this are marked over-knee (queueing delay diverges)")
define_flag("FLAGS_capacity_calib_beats", 32,
            "decode beats the calibration measures per active level when "
            "fitting the device profile's beat_ms base and slope "
            "(static/capacity.calibrate)")
# Link tiers of an H100 HGX node (distributed/mesh.py axis_tiers): "ici"
# is NVLink 4 within the node, 900 GB/s per GPU both ways together, 450
# one way (NVIDIA H100 data sheet); "dcn" is the network between nodes,
# one 400 Gb/s ConnectX-7 InfiniBand port per GPU, 50 GB/s one way (DGX
# H100 user guide).
define_flag("FLAGS_topology_ici_gbps", 450.0,
            "per-device link bandwidth in GB/s, one way, within a node "
            "(NVLink 4 on the H100) for the two-tier topology cost model "
            "(mesh.axis_tiers)")
define_flag("FLAGS_topology_dcn_gbps", 50.0,
            "per-device link bandwidth in GB/s, one way, between nodes "
            "(one 400 Gb/s InfiniBand port per H100) for the two-tier "
            "topology cost model and capacity.publish_wire_ms")
# --- the SPMD analyzer and planner (static/spmd_analyzer.py,
# --- static/spmd_planner.py) and elastic training (distributed/elastic.py)
define_flag("FLAGS_log_spmd_estimate", False,
            "on each fresh Executor compile with a registered mesh, run "
            "the SPMD sharding analyzer (static/spmd_analyzer.py) and "
            "publish the spmd.{collective_bytes,hbm_estimate,"
            "resharding_count} monitor gauges (non-strict; set "
            "PADDLE_TPU_VERIFY_SPMD=1 to fail the compile on findings)")
define_flag("FLAGS_spmd_plan_beam", 4,
            "beam width of the auto-sharding planner's grouped search "
            "(static/spmd_planner.py); wide enough to carry a "
            "chain-opening candidate (column-parallel qkv) to the "
            "row-parallel out-proj that closes it")
define_flag("FLAGS_spmd_plan_sweeps", 1,
            "coordinate-descent polish passes the planner runs over the "
            "beam winner (feasible moves only; 0 disables)")
define_flag("FLAGS_spmd_plan_coll_weight", 1.0,
            "planner objective weight on predicted collective bytes a "
            "step")
define_flag("FLAGS_spmd_plan_hbm_weight", 1.0,
            "planner objective weight on the predicted peak device "
            "memory a rank")
define_flag("FLAGS_spmd_plan_pp_micro", 8,
            "micro-batch count the stage-cut planner prices a step with "
            "(spmd_planner.plan_pipeline)")
define_flag("FLAGS_spmd_plan_pp_beam", 8,
            "beam width of the stage-cut search over legal cut "
            "boundaries")
define_flag("FLAGS_spmd_plan_pp_flops_weight", 1.0,
            "stage-cut objective weight on max(stage FLOPs) * num_micro")
define_flag("FLAGS_spmd_plan_pp_wire_weight", 1.0,
            "stage-cut objective weight on the point-to-point bytes a "
            "step (pipeline.schedule_collectives)")
define_flag("FLAGS_spmd_plan_pp_hbm_weight", 1.0,
            "stage-cut objective weight on the largest stage's peak "
            "memory")
define_flag("FLAGS_spmd_plan_pp_bubble_weight", 1.0,
            "stage-cut objective weight on bubble_fraction * total FLOPs")
define_flag("FLAGS_topology_localsgd_k", 4,
            "k_steps the topology report prices the LocalSGD sync mode "
            "with (one average every k local steps)")
define_flag("FLAGS_topology_localsgd_ratio", 8.0,
            "when the hierarchical dp sync's between-node cost exceeds "
            "its within-node cost by this factor, the topology report "
            "recommends LocalSGD")
define_flag("PADDLE_ELASTIC_MAX_RESTARTS", 3,
            "restart budget of the elastic supervisor "
            "(distributed/elastic.py Supervisor, launch.py --elastic): a "
            "rank (a process group: the whole group) that dies or stalls "
            "more often fails the job with the child's exit status")
define_flag("PADDLE_ELASTIC_RESTART_BACKOFF_S", 1.0,
            "base pause before an elastic restart; grows linearly with "
            "the restart count")
define_flag("PADDLE_ELASTIC_STALL_TIMEOUT_S", 300.0,
            "a trainer whose heartbeat beats but whose step has not "
            "advanced for this long is flight-recorded, killed and "
            "restarted")
define_flag("PADDLE_ELASTIC_HEARTBEAT_TIMEOUT_S", 60.0,
            "a trainer whose heartbeat file is older than this (or "
            "unreadable) is declared dead and restarted")
