"""Command-line tools of the port, run as ``python -m
paddle_tpu_torch.tools.<name>`` (the counterparts of the repo's
``tools/*.py``, which drive the JAX package): ``capacity_plan`` (the
serve capacity model and its closed-loop validation), ``ps_load_test``
(PS transport throughput and failover drills), ``cluster_obs_drill``
(the telemetry plane's multi-process drill), ``spmd_lint`` and
``spmd_plan`` (the SPMD analyzer's report and the planner's plans for
the GPT workload) and ``elastic_drill`` (a SIGKILLed PS trainer resumed
bitwise under the supervisor)."""
