"""PSServer — hosts tables, serves pull/push, optionally replicates
(paddle_tpu/distributed/ps/server.py, whole; the port's own copy).

Analog of reference N21 PSServer (distributed/service/brpc_ps_server.cc:
service handlers pull_dense/push_dense_param/push_sparse/...; table map
from ps.proto) and N20 listen_and_serv_op (operators/pscore/
listen_and_serv_op.cc server loop). The server is compute-free: update
rules live in the tables (table.py), the RPC layer is rpc.py, and the
replicated-storage protocols (shard-map routing, primary->backup
forwarding, heartbeat failover, catch-up) live in replica.py — enabled
per-server with `enable_replication()` after `start()`.
"""
from __future__ import annotations

import threading

import numpy as np

from .replica import REPLICATED_MUTATIONS
from .rpc import ReplayCache, serve
from .table import SparseTable, make_table

__all__ = ["PSServer"]


class PSServer:
    def __init__(self, endpoint="127.0.0.1:0", tables: dict | None = None,
                 replica: dict | None = None):
        """tables: name -> table spec dict (see table.make_table) or a
        ready table object. replica: optional kwargs for
        `enable_replication`, applied automatically once `start()` has
        bound the port (the manager needs the real endpoint)."""
        self._tables = {}
        for name, spec in (tables or {}).items():
            self.add_table(name, spec)
        self._stop = threading.Event()
        self._endpoint = endpoint
        self._thread = None
        self.port = None
        # shared with serve() AND the replica catch-up path, which
        # registers delta-log rids so live forwards dedupe against them
        self.replay = ReplayCache()
        self._replica = None
        self._replica_cfg = dict(replica) if replica else None

    # -------------------------------------------------------------- admin
    def add_table(self, name, spec):
        self._tables[name] = spec if not isinstance(spec, dict) \
            else make_table(spec)

    def table(self, name):
        return self._tables[name]

    @property
    def replica(self):
        return self._replica

    def start(self):
        self.port, self._thread = serve(self._endpoint, self._handle,
                                        self._stop, replay=self.replay)
        host = self._endpoint.rsplit(":", 1)[0]
        self.endpoint = f"{host}:{self.port}"
        if self._replica_cfg is not None:
            self.enable_replication(**self._replica_cfg)
        return self.endpoint

    def enable_replication(self, **kwargs):
        """Attach a replica.ReplicaManager (call after start(); the
        manager identifies this server by its bound endpoint). kwargs:
        shard_map, peers, n_backups, heartbeat_s, heartbeat_timeout_s,
        rpc_opts, rejoin — see ReplicaManager."""
        if self._thread is None:
            raise RuntimeError("enable_replication() requires a started "
                               "server (the bound endpoint is its id)")
        from .replica import ReplicaManager
        self._replica = ReplicaManager(self, self.endpoint, **kwargs)
        return self._replica

    def run(self):
        """Block until a peer calls stop (reference fleet.run_server)."""
        if self._thread is None:
            self.start()
        self._stop.wait()

    def shutdown(self):
        self._stop.set()
        if self._replica is not None:
            self._replica.close()
        # join the accept loop so the port is RELEASED when we return —
        # an elastic restart rebinds the same endpoint immediately
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    # ----------------------------------------------------------- handlers
    def _apply_table_op(self, t, method, req):
        """One table operation — shared by the live request path and the
        replica catch-up delta replay."""
        if method == "pull_dense":
            return t.pull()
        if method == "push_dense_grad":
            t.push_grad(req["grad"])
            return True
        if method == "set_dense":
            t.set(req["value"])
            return True
        if method == "pull_sparse":
            return t.pull(req["ids"])
        if method == "push_sparse_grad":
            t.push_grad(req["ids"], req["grads"])
            return True
        if method == "push_sparse_delta":
            t.push_delta(req["ids"], req["deltas"])
            return True
        if method == "barrier":
            return t.wait(req["trainer_id"], req.get("timeout", 120.0))
        if method == "table_state":
            return t.state()
        if method == "table_applied":
            # how many pushes this table has APPLIED — replayed retries
            # don't re-apply, so chaos tests can assert exactly-once
            # through the public RPC surface
            return int(getattr(t, "applied", 0))
        if method == "load_table_state":
            t.load_state(req["state"])
            return True
        if method == "table_size":
            return len(t) if isinstance(t, SparseTable) else \
                int(np.prod(t.param.shape))
        raise ValueError(f"unknown PS method {method!r}")

    def _handle(self, method, req, rid=None):
        if method == "stop":
            self._stop.set()
            return True
        if method == "ping":
            return "pong"
        if method == "list_tables":
            return {n: type(t).__name__ for n, t in self._tables.items()}
        if method == "get_shard_map":
            return self._replica.map_dict() if self._replica else None
        if method == "install_shard_map":
            if self._replica is None:
                return False
            return self._replica.install(req["shard_map"])
        if method == "replica_beat":
            if self._replica is None:
                return {"epoch": -1}
            return self._replica.on_beat(req["from"], req.get("epoch", 0))
        if method == "replica_fetch":
            if self._replica is None:
                raise RuntimeError("replication is not enabled here")
            return self._replica.fetch()
        if method == "replica_attach":
            if self._replica is None:
                raise RuntimeError("replication is not enabled here")
            return self._replica.attach(req["endpoint"], req["shard"],
                                        req.get("seqs", {}))
        if method == "save_snapshot":
            # mid-train fault-tolerance snapshot (reference
            # operators/distributed/large_scale_kv.h SaveToSelectedRows /
            # table checkpointing): every table's full state to local disk,
            # written atomically (tmp + rename)
            import os
            import pickle
            path = req["path"]
            state = {n: t.state() for n, t in self._tables.items()
                     if hasattr(t, "state")}
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(state, f, protocol=4)
            os.replace(tmp, path)
            return sorted(state)
        if method == "load_snapshot":
            import pickle
            with open(req["path"], "rb") as f:
                state = pickle.load(f)  # noqa: S301 — server-local file
            for n, st in state.items():
                if n in self._tables and hasattr(self._tables[n],
                                                 "load_state"):
                    self._tables[n].load_state(st)
            return sorted(state)

        # ---- data path: shard-map routing check, apply, replicate ----
        mgr = self._replica
        shard = is_forward = None
        if mgr is not None:
            shard, is_forward = mgr.check(method, req)
        else:
            # unreplicated server: drop routing keys a shard-map client
            # may still stamp (mixed clusters during rollout)
            req.pop("__shard__", None)
            req.pop("__epoch__", None)
            req.pop("__fwd__", None)
        tname = req.pop("table")
        t = self._tables[tname]
        if mgr is not None and method in REPLICATED_MUTATIONS \
                and mgr.replicates(tname):
            # apply + log + forward atomically per table: per-table
            # forwards leave in sequence order over the serialized
            # backup connection, and the ack returns only after the
            # write is durable on the quorum
            with mgr.gate(tname):
                # a quorum-failure retry re-enters under its ORIGINAL
                # rid with the mutation already applied+logged here:
                # skip the apply, re-run forward+quorum only
                replayed = rid is not None and mgr.seen(tname, rid)
                result = None if replayed \
                    else self._apply_table_op(t, method, req)
                mgr.record_and_forward(tname, shard, method, req, rid,
                                       bool(is_forward),
                                       log_entry=not replayed)
            return result
        return self._apply_table_op(t, method, req)
