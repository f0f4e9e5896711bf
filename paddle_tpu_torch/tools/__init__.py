"""Command-line tools of the port, run as ``python -m
paddle_tpu_torch.tools.<name>`` (the counterparts of the repo's
``tools/*.py``, which drive the JAX package): ``capacity_plan`` (the
serve capacity model and its closed-loop validation), ``ps_load_test``
(PS transport throughput and failover drills) and ``cluster_obs_drill``
(the telemetry plane's multi-process drill)."""
