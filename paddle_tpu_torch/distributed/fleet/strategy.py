"""DistributedStrategy (paddle_tpu/distributed/fleet/strategy.py; the
reference's framework/distributed_strategy.proto): the same knobs and
defaults. The port's ``Model.fit`` reads ``sharding`` (ZeRO over dp),
``localsgd`` / ``adaptive_localsgd`` with ``localsgd_configs``,
``recompute`` with ``recompute_configs`` and ``amp`` with
``amp_configs``; ``fleet.init`` reads ``hybrid_configs``; ``a_sync``
selects the parameter-server tier's async Communicator. The rest
(``dgc``, ``fuse_all_reduce_ops``, ``nccl_comm_num``,
``fuse_grad_size_in_MB``, ...) are accepted so that reference configs
load, and change nothing.
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]


class DistributedStrategy:
    def __init__(self):
        # mirroring proto defaults
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_bf16": True,
                            "use_dynamic_loss_scaling": True, "level": "O1"}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"segment_broadcast_MB": 32,
                                 "sharding_degree": 8, "stage": 2}
        # auto_shard: derive PartitionSpecs with the planner
        # (static/spmd_planner.py) at compile instead of the hand-written
        # COLUMN_PARALLEL/ROW_PARALLEL presets. Configs may carry a
        # pre-searched "plan" (ShardingPlan), a "mesh" ({axis: size}
        # dict), "names" (scope->dotted), "data_specs", "zero_dp" and the
        # objective weights; everything defaults from the fleet mesh.
        self.auto_shard = False
        self.auto_shard_configs = {}
        self.pipeline = False
        # The planner writes searched stage assignments into this same
        # knob surface (static/spmd_planner.ShardingPlan.as_strategy
        # when the plan carries pipeline cuts): "num_virtual" (chunks
        # per rank, interleaved 1F1B when > 1), "pp_degree" and
        # "stage_op_ranges" (the planned per-stage op ranges) join the
        # reference keys; the Executor resolves them onto the Program
        # as _pipeline_stages before the VERIFY_SPMD hook runs.
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B", "num_virtual": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lamb_configs = {}
        self.lars = False
        self.lars_configs = {}
        self.dgc = False
        self.dgc_configs = {}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.adaptive_localsgd = False
        # hierarchical_allreduce: dp gradient sync as the three-phase
        # pod-aware decomposition (collective.hierarchical_all_reduce:
        # reduce-scatter over inner_axes, all-reduce the shard over
        # outer_axes, all-gather back). Flipped by
        # ShardingPlan.as_strategy() when the planned mesh declares a
        # slow link tier and the cost model recommends it.
        self.hierarchical_allreduce = False
        self.hierarchical_allreduce_configs = {"inner_axes": [],
                                               "outer_axes": []}
        self.a_sync = False
        self.a_sync_configs = {}
        self.elastic = False
        self.nccl_comm_num = 1  # parity no-op: no NCCL comms to count
        self.fuse_all_reduce_ops = True  # XLA fuses; accepted for parity
        self.fuse_grad_size_in_MB = 32
        self.hybrid_configs = {"dp_degree": -1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "ep_degree": 1}
        self.find_unused_parameters = False
        self.heter_ccl_mode = False

    # dict-style hybrid_configs setter parity
    def __setattr__(self, key, value):
        if key == "hybrid_configs" and isinstance(value, dict) \
                and hasattr(self, "hybrid_configs"):
            merged = dict(self.__dict__.get("hybrid_configs", {}))
            merged.update(value)
            self.__dict__[key] = merged
            return
        self.__dict__[key] = value

    def to_dict(self):
        return {k: v for k, v in self.__dict__.items()}

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on}, hybrid={self.hybrid_configs})"
