"""paddle.distributed.fleet (paddle_tpu/distributed/fleet; the
reference's fleet_base.py): ``init`` / ``DistributedStrategy`` / role
makers, ``distributed_optimizer`` and ``distributed_model``, the
hybrid-parallel building blocks (``meta_parallel``) and the
parameter-server worker / server facade.

``init(is_collective=True)`` joins the process group (``bootstrap``) and
declares the mesh from the strategy's ``hybrid_configs`` (dp, mp -> tp,
pp, sep -> sp, ep; one process per mesh position). The strategy's knobs
are declarative, as in the JAX package: ``DistributedOptimizer`` marks the
optimizer, and ``Model.fit`` reads the marks (ZeRO, LocalSGD, recompute,
AMP). ``init(is_collective=False)`` is parameter-server mode over
``distributed/ps``. On a static Program ``minimize`` tags the strategy's
``recompute``, ``auto_shard`` and AMP for the static Executor, and
``spmd_report`` runs the SPMD analyzer against the fleet mesh.
"""
from __future__ import annotations

import os

from .. import mesh as mesh_mod
from ..env import ParallelEnv, get_rank, get_world_size
from .strategy import DistributedStrategy  # noqa: F401
from .role_maker import (PaddleCloudRoleMaker, Role, UserDefinedRoleMaker)  # noqa: F401
from . import meta_parallel, role_maker, strategy, util  # noqa: F401
from .meta_parallel import (ColumnParallelLinear, LayerDesc,  # noqa: F401
                            PipelineLayer, RowParallelLinear,
                            VocabParallelEmbedding, get_rng_state_tracker)

__all__ = ["init", "DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "distributed_optimizer", "worker_index",
           "worker_num", "is_first_worker", "is_worker", "is_server",
           "worker_endpoints", "barrier_worker", "init_worker",
           "stop_worker", "init_server", "run_server", "ps_client",
           "ps_communicator", "DistributedOptimizer",
           "get_hybrid_communicate_group", "spmd_report"]

_fleet_state = {
    "initialized": False,
    "role_maker": None,
    "strategy": None,
    "is_collective": True,
    "hcg": None,
}


def init(role_maker=None, is_collective=True, strategy=None):
    """reference fleet_base.py:130. Declares the mesh from the strategy's
    hybrid degrees over the world's ranks.

    With is_collective=False the job is parameter-server mode (reference
    fleet/runtime/the_one_ps.py): no mesh and no process group; workers
    talk to servers through distributed.ps (PADDLE_PSERVERS_IP_PORT_LIST
    env contract, reference distributed/utils.py:406-409)."""
    strategy = strategy or DistributedStrategy()
    _fleet_state.update(initialized=True, role_maker=role_maker,
                        strategy=strategy, is_collective=is_collective)
    if not is_collective:
        if role_maker is None:
            _fleet_state["role_maker"] = PaddleCloudRoleMaker(
                is_collective=False)
        return _FleetFacade()
    from ..bootstrap import maybe_initialize_distributed
    maybe_initialize_distributed()
    n = mesh_mod.world_size()
    degrees = strategy.hybrid_configs
    dp = degrees.get("dp_degree", -1)
    mp = degrees.get("mp_degree", 1)
    pp = degrees.get("pp_degree", 1)
    sp = degrees.get("sep_degree", degrees.get("sp_degree", 1))
    ep = degrees.get("ep_degree", 1)
    fixed = mp * pp * sp * ep
    if dp == -1:
        dp = max(n // max(fixed, 1), 1)
    shape = {}
    if dp > 1 or fixed == 1:
        shape["dp"] = dp
    if mp > 1:
        shape["tp"] = mp
    if pp > 1:
        shape["pp"] = pp
    if sp > 1:
        shape["sp"] = sp
    if ep > 1:
        shape["ep"] = ep
    if not shape:
        shape = {"dp": n}
    total = 1
    for v in shape.values():
        total *= v
    if total != n:
        raise ValueError(
            f"hybrid parallel degrees {dict(degrees)} imply mesh {shape} "
            f"({total} ranks) but the world has {n}; degrees must factor "
            f"the world size exactly (one process per mesh position)")
    mesh_mod.init_mesh(shape)
    _fleet_state["hcg"] = HybridCommunicateGroup(shape)
    return _FleetFacade()


def spmd_report(program=None, layer=None, mesh=None, data_specs=None,
                tokens_per_step=None, zero_dp=False):
    """The static SPMD analyzer's report against the fleet mesh
    (``static/spmd_analyzer.py``): resolved PartitionSpecs, the implied
    collectives with their bytes a rank, the peak-memory estimate a rank
    and the diagnostics.

    Pass a static ``program`` (optionally with a ``layer`` so the TP
    name patterns see dotted parameter paths), or just a ``layer`` /
    parameter dict for the dygraph path. ``mesh`` defaults to the fleet
    mesh; an {axis: size} dict needs no process group."""
    from ...static import spmd_analyzer as spmd
    from .. import sharding as sharding_mod
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if program is not None:
        param_specs = getattr(program, "spmd_param_specs", None)
        if param_specs is None and layer is not None:
            param_specs = sharding_mod.named_param_specs(
                layer, mesh, zero_dp=zero_dp)
        if data_specs is None:  # the VERIFY_SPMD hook's default
            data_specs = getattr(program, "spmd_data_specs", None)
        return spmd.analyze_program(program, mesh=mesh,
                                    param_specs=param_specs,
                                    data_specs=data_specs)
    if layer is None:
        raise ValueError("spmd_report needs a program or a layer")
    params = dict(layer.named_parameters()) if hasattr(
        layer, "named_parameters") else dict(layer)
    return spmd.analyze_params(params, mesh=mesh,
                               tokens_per_step=tokens_per_step,
                               zero_dp=zero_dp)


class HybridCommunicateGroup:
    """Topology info (reference fleet/base/topology.py
    HybridCommunicateGroup): the axis sizes and this process's position
    along each."""

    def __init__(self, shape):
        self.shape = dict(shape)

    def _coords(self):
        """This rank's position along each axis of the fleet mesh (rank r
        at the row-major coordinates of r in the mesh shape)."""
        mesh = mesh_mod.get_mesh()
        if mesh is not None and set(self.shape) <= set(mesh.axis_names):
            return mesh.coords()
        r = get_rank()
        coords = {}
        for ax in reversed(list(self.shape)):  # row-major, last fastest
            coords[ax] = r % self.shape[ax]
            r //= self.shape[ax]
        return coords

    def _rank(self, axis):
        return int(self._coords().get(axis, 0))

    def get_data_parallel_world_size(self):
        return self.shape.get("dp", 1)

    def get_model_parallel_world_size(self):
        return self.shape.get("tp", 1)

    def get_pipe_parallel_world_size(self):
        return self.shape.get("pp", 1)

    def get_sep_parallel_world_size(self):
        return self.shape.get("sp", 1)

    def get_expert_parallel_world_size(self):
        return self.shape.get("ep", 1)

    def get_data_parallel_rank(self):
        return self._rank("dp")

    def get_model_parallel_rank(self):
        return self._rank("tp")

    def get_stage_id(self):
        return self._rank("pp")

    def get_sep_parallel_rank(self):
        return self._rank("sp")

    def get_expert_parallel_rank(self):
        return self._rank("ep")


def get_hybrid_communicate_group():
    return _fleet_state["hcg"]


def worker_index():
    rm = _fleet_state.get("role_maker")
    return rm.worker_index() if rm is not None else get_rank()


def worker_num():
    rm = _fleet_state.get("role_maker")
    return rm.worker_num() if rm is not None else get_world_size()


def is_first_worker():
    rm = _fleet_state.get("role_maker")
    return rm.is_first_worker() if rm is not None else get_rank() == 0


def is_worker():
    rm = _fleet_state.get("role_maker")
    return rm.is_worker() if rm is not None else True


def is_server():
    rm = _fleet_state.get("role_maker")
    return rm.is_server() if rm is not None else False


def worker_endpoints(to_string=False):
    eps = ParallelEnv().trainer_endpoints
    return ",".join(eps) if to_string else eps


def barrier_worker():
    from ..collective import barrier
    barrier()


def init_worker():
    """PS mode: connect a PSClient to all servers; strategy.a_sync adds
    the background Communicator (reference fleet_base.py init_worker ->
    the_one_ps._init_worker + communicator start)."""
    if _fleet_state["is_collective"]:
        return
    from ..ps import Communicator, PSClient
    rm = _fleet_state.get("role_maker")
    eps = rm.get_pserver_endpoints() if rm is not None else []
    if not eps:
        eps = [e for e in os.environ.get(
            "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
    if not eps:
        raise RuntimeError(
            "PS mode needs server endpoints: pass them to the role maker "
            "(UserDefinedRoleMaker(server_endpoints=[...])) or set "
            "PADDLE_PSERVERS_IP_PORT_LIST (comma-separated host:port list)")
    client = PSClient(eps)
    _fleet_state["ps_client"] = client
    strategy = _fleet_state["strategy"]
    if strategy is not None and strategy.a_sync:
        cfg = strategy.a_sync_configs or {}
        _fleet_state["ps_communicator"] = Communicator(
            client, send_every=cfg.get("send_queue_size", 4))


def ps_client():
    c = _fleet_state.get("ps_client")
    if c is None:
        raise RuntimeError("call fleet.init_worker() first")
    return c


def ps_communicator():
    return _fleet_state.get("ps_communicator")


def stop_worker():
    """Drain the communicator, rendezvous ALL workers at the server-side
    stop barrier (so no server dies under a still-training peer), then
    the first worker shuts the servers down (reference: trainers
    deregister before pserver exit, heart_beat_monitor.cc)."""
    if _fleet_state["is_collective"]:
        return
    comm = _fleet_state.pop("ps_communicator", None)
    if comm is not None:
        comm.flush()
        comm.stop()
    client = _fleet_state.pop("ps_client", None)
    if client is not None:
        try:
            client.barrier(_STOP_BARRIER, worker_index())
        except (RuntimeError, ConnectionError, OSError):
            # pre-ps-stack server config without the barrier table, or
            # servers already gone/unreachable — teardown must still
            # proceed to close() so the worker exits cleanly
            pass
        if is_first_worker():
            try:
                client.stop_servers()
            except (ConnectionError, OSError):
                pass  # servers already dead is a successful stop
        client.close()


_STOP_BARRIER = "_fleet_stop_barrier"


def init_server(tables=None, endpoint=None):
    """Build this process's PSServer from table specs (reference
    fleet.init_server building tables out of ps.proto TableParameters;
    here specs are explicit dicts — see distributed.ps.make_table). A
    stop barrier sized to the trainer count is provisioned automatically
    so stop_worker can rendezvous before servers exit.

    With PADDLE_PS_REPLICA_BACKUPS > 0 and a full endpoint list in
    PADDLE_PSERVERS_IP_PORT_LIST, the server joins the replicated
    storage tier: every server derives the SAME initial shard map from
    the endpoint list (chained primary/backup layout), so no bootstrap
    rendezvous is needed — promotions and rejoins evolve the map from
    there (distributed/ps/replica.py)."""
    from ...core.flags import flag as _flag
    from ..ps import PSServer, ShardMap
    eps = [e for e in os.environ.get(
        "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
    if endpoint is None:
        idx = int(os.environ.get("PADDLE_PSERVER_ID", "0"))
        endpoint = eps[idx] if eps else "127.0.0.1:0"
    tables = dict(tables or {})
    tables.setdefault(_STOP_BARRIER, {
        "type": "barrier",
        "trainer_num": int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))})
    n_backups = int(_flag("PADDLE_PS_REPLICA_BACKUPS"))
    replica = None
    if n_backups > 0 and len(eps) > 1 and ":0" not in endpoint:
        replica = {"shard_map": ShardMap.create(eps, n_backups),
                   "peers": eps, "n_backups": n_backups}
    server = PSServer(endpoint, tables, replica=replica)
    _fleet_state["ps_server"] = server
    server.start()
    return server


def run_server():
    """Blocks serving pull/push until a worker sends stop (reference
    pscore/listen_and_serv_op.cc server loop)."""
    server = _fleet_state.get("ps_server")
    if server is None:
        raise RuntimeError("call fleet.init_server() first")
    server.run()


class DistributedOptimizer:
    """Strategy-composing optimizer wrapper (reference fleet_base.py:593 +
    StrategyCompiler). Effects are declarative: ``Model.fit`` and the
    static Executor read the marks it leaves on the optimizer."""

    def __init__(self, optimizer, strategy: DistributedStrategy):
        self.inner_opt = optimizer
        self.user_defined_strategy = strategy
        optimizer._dist_strategy = strategy  # engine reads these
        if strategy.sharding:
            optimizer._zero_dp = True
        if strategy.amp:
            # O2/pure-bf16 keeps f32 master weights in the optimizer (the
            # reference amp meta-optimizer's rewrite, declaratively)
            level = strategy.amp_configs.get("level", "O1")
            if level == "O2" or strategy.amp_configs.get("use_pure_bf16"):
                optimizer._multi_precision = True

    def __getattr__(self, item):
        return getattr(self.inner_opt, item)

    def __setattr__(self, key, value):
        # the wrapper is transparent: AMP's decorate and the engine set
        # the inner optimizer's state (its master weights' switch ...)
        if key in ("inner_opt", "user_defined_strategy"):
            object.__setattr__(self, key, value)
        else:
            setattr(self.inner_opt, key, value)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The inner optimizer's ``minimize``; on a static Program the
        strategy becomes the Program's tags, which the static Executor
        reads at compile: ``auto_shard`` (``_auto_shard``: the planner's
        ``resolve_auto_shard``), ``recompute`` (``recompute_checkpoints``
        and ``recompute_policy``: the recompute segments) and AMP
        (``amp_level``, ``amp_dtype``, ``amp_lists``)."""
        strategy = self.user_defined_strategy
        static = hasattr(loss, "program")
        if static and getattr(strategy, "auto_shard", False):
            from ...static.program import default_main_program
            program = loss.program or default_main_program()
            program._auto_shard = dict(
                getattr(strategy, "auto_shard_configs", None) or {})
        if static and strategy.recompute:
            from ...static.program import default_main_program
            program = loss.program or default_main_program()
            cfg = strategy.recompute_configs or {}
            program.recompute_checkpoints = tuple(
                v.name if hasattr(v, "name") else str(v)
                for v in cfg.get("checkpoints", ()))
            program.recompute_policy = cfg.get("policy", "nothing")
        if strategy.amp and static:
            import torch
            from ...static.program import default_main_program
            program = loss.program or default_main_program()
            cfg = strategy.amp_configs
            program.amp_level = "O2" if cfg.get("use_pure_bf16") \
                else cfg.get("level", "O1")
            program.amp_dtype = torch.float16 \
                if str(cfg.get("dtype", "bfloat16")) in ("float16", "fp16") \
                else torch.bfloat16
            if cfg.get("custom_white_list") or cfg.get("custom_black_list"):
                from ... import amp as amp_mod
                white = amp_mod.white_list() \
                    | set(cfg.get("custom_white_list") or ())
                black = (amp_mod.black_list()
                         | set(cfg.get("custom_black_list") or ())) \
                    - set(cfg.get("custom_white_list") or ())
                program.amp_lists = (frozenset(white), frozenset(black))
        return self.inner_opt.minimize(loss, startup_program, parameters,
                                       no_grad_set)

    def step(self):
        return self.inner_opt.step()

    def clear_grad(self):
        return self.inner_opt.clear_grad()

    def state_dict(self):
        return self.inner_opt.state_dict()

    def set_state_dict(self, state):
        return self.inner_opt.set_state_dict(state)


def distributed_optimizer(optimizer, strategy=None):
    strategy = strategy or _fleet_state.get("strategy") or DistributedStrategy()
    return DistributedOptimizer(optimizer, strategy)


def distributed_model(model):
    """reference fleet.distributed_model — wraps for data parallelism."""
    from ..parallel import DataParallel
    return DataParallel(model)


class _FleetFacade:
    """Object returned by fleet.init supporting the fluent API."""

    distributed_optimizer = staticmethod(distributed_optimizer)
    distributed_model = staticmethod(distributed_model)
    worker_index = staticmethod(worker_index)
    worker_num = staticmethod(worker_num)
    is_first_worker = staticmethod(is_first_worker)
    barrier_worker = staticmethod(barrier_worker)

    @property
    def util(self):
        from .util import UtilBase
        return UtilBase()
