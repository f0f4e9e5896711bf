"""Traffic lab (paddle_tpu/traffic): deterministic workload generation
and the shared load harness."""
from .harness import (HarnessReport, PoolRun, ServeStats, Submission,
                      Window, build_tiny_loop, drive_serve, run_spec,
                      run_worker_pool, submissions_from_events,
                      submissions_from_prompts)
from .workload import (BUILTIN_SPECS, Event, Stream, WorkloadGenerator,
                       WorkloadSpec, builtin_spec, schedule,
                       schedule_digest)

__all__ = ["Stream", "WorkloadSpec", "WorkloadGenerator", "Event",
           "schedule", "schedule_digest", "builtin_spec", "BUILTIN_SPECS",
           "Submission", "ServeStats", "drive_serve", "run_worker_pool",
           "PoolRun", "Window", "run_spec", "HarnessReport",
           "build_tiny_loop", "submissions_from_prompts",
           "submissions_from_events"]
