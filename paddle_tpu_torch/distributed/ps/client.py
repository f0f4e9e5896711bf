"""PSClient + Communicator — the worker side of the PS stack
(paddle_tpu/distributed/ps/client.py, whole).

A torch tensor never goes on the wire: ``_host`` turns the ids, grads
and deltas a caller passes into numpy at this boundary, one host copy a
call (a CUDA tensor is copied to the host once, never row by row), so
the frames are the JAX package's and either package's client talks to
either package's server.

Analogs: reference N21 PSClient (distributed/service/ps_client.h:
pull_dense/push_dense/pull_sparse/push_sparse futures), N20 row splitting
across servers (operators/distributed/parameter_send.cc: rows hashed to
sections, one RPC per server) and the background-send Communicator
(operators/distributed/communicator.cc: AsyncCommunicator merges grads in
queues and flushes every send_wait_times; GeoCommunicator pushes deltas).

Sharding is owned by a cached, versioned `ShardMap` (shard_map.py):
sparse ids hash onto shards with `id % n_shards`, dense AND barrier
tables with `crc32(name) % n_shards`, and every data call routes to the
shard's PRIMARY, stamped with the map's epoch. Against an unreplicated
cluster the default map makes this bit-identical to the legacy
`id % n_servers` rule. Against a replicated cluster the client fails
over: a `ShardMapStale` redirect installs the server's newer map and
re-routes; a dead endpoint (ConnectRefused / exhausted transport)
triggers a map refresh from the surviving servers and a bounded
re-route loop (`PADDLE_PS_FAILOVER_RETRIES` x
`PADDLE_PS_FAILOVER_BACKOFF_S`) that rides out a heartbeat-driven
promotion. Replay ids for mutating calls are minted by the CLIENT (not
the connection), so the retry that lands on the promoted backup dedupes
against the forward the dead primary already delivered — exactly-once
holds across failover, not just across resends.
"""
from __future__ import annotations

import queue
import threading
import time
import uuid
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...core import monitor as _monitor
from ...core import trace as _trace
from ...core.flags import flag as _flag
from .rpc import ConnectRefused, Connection
from .shard_map import ShardMap, ShardMapStale

__all__ = ["PSClient", "Communicator"]


def _host(x):
    """numpy of a caller's ids / grads / deltas: a torch tensor (on any
    device) is copied to the host in one piece, bf16 widened to f32;
    anything else goes through np.asarray."""
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return x


class PSClient:
    """Every fan-out routes through the retrying `rpc.Connection`, and
    mutating calls (push_*/set_dense/barrier) are stamped for idempotent
    replay — a retried push after a lost response applies exactly once.
    `**rpc_opts` (timeout, max_retries, backoff_base, ...) override the
    PADDLE_PS_* flag defaults per client."""

    # Communicator probes this before threading request_keys through
    # push_* (test doubles with bare push signatures stay valid)
    supports_request_keys = True

    def __init__(self, server_endpoints, shard_map=None, client_id=None,
                 **rpc_opts):
        if isinstance(server_endpoints, str):
            server_endpoints = server_endpoints.split(",")
        self.endpoints = list(server_endpoints)
        self._rpc_opts = dict(rpc_opts)
        # one client is shared between the trainer thread and the
        # Communicator send thread; every _conns read-modify (and any
        # iteration) holds this lock — Connection.call serializes itself
        self._conns_lock = threading.Lock()
        self._conns: dict[str, Connection | None] = {}
        errors = []
        for ep in self.endpoints:
            try:
                self._conns[ep] = Connection(ep, **rpc_opts)
            except (ConnectionError, OSError) as e:
                # a dead member of a replicated cluster must not keep a
                # fresh worker from joining; the map routes around it.
                # All-dead still fails loudly below.
                self._conns[ep] = None
                errors.append(e)
        if errors and len(errors) == len(self.endpoints):
            raise errors[0]
        # client-owned replay-id namespace: stable across failover
        # re-routes of one logical call (connection ids are not)
        self._client_id = client_id or uuid.uuid4().hex
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._map_lock = threading.Lock()
        # shard-map change listeners (HeterPSCache invalidation rides
        # these) + the lazy per-shard fan-out pool for batched lookups
        self._listeners: list = []
        self._fanout_pool: ThreadPoolExecutor | None = None
        self._fanout_lock = threading.Lock()
        if shard_map is not None:
            self._map = shard_map if isinstance(shard_map, ShardMap) \
                else ShardMap.from_dict(shard_map)
        else:
            self._map = ShardMap.default(self.endpoints)
            self.refresh_shard_map()

    # ----------------------------------------------------------- shard map
    @property
    def shard_map(self) -> ShardMap:
        return self._map

    @property
    def n_servers(self):
        return len(self.endpoints)

    def _adopt(self, map_dict):
        """Install a map if it is newer; newest epoch always wins."""
        if not map_dict:
            return False
        new = ShardMap.from_dict(map_dict)
        with self._map_lock:
            if new.epoch <= self._map.epoch:
                return False
            self._map = new
        if new.epoch > 0 or any(new.backups(s)
                                for s in range(new.n_shards)):
            self._enable_fail_fast()
        # a membership change invalidates every derived caching layer:
        # listeners fire OUTSIDE the map lock (an invalidation may pull)
        for ref in list(self._listeners):
            fn = ref()
            if fn is None:
                try:       # owner died: the weak registration self-prunes
                    self._listeners.remove(ref)
                except ValueError:
                    pass
                continue
            try:
                fn(new)
            except Exception:  # noqa: BLE001 — listeners must not block
                pass           # adoption (routing correctness comes first)
        return True

    def add_map_listener(self, fn):
        """Register fn(new_map), called after every shard-map adoption
        (stale redirect, failover refresh, epoch gossip). The sharded
        caching tier registers its invalidation here so a stale cached
        row can never survive a membership change. Bound methods are
        held WEAKLY — a discarded cache unregisters itself instead of
        being pinned (and fired) for the client's whole lifetime."""
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            # plain function/lambda: no owner to outlive, pin it
            ref = (lambda f=fn: f)
        self._listeners.append(ref)
        return fn

    def _enable_fail_fast(self):
        # with backups in the map a refused dial means "fail over NOW",
        # not "wait out the connect window"
        with self._conns_lock:
            conns = list(self._conns.values())
        for c in conns:
            if c is not None:
                c.fail_fast_refused = True

    def refresh_shard_map(self):
        """Ask every reachable server for its map; adopt the newest.
        Returns True if the map advanced. Endpoints that were dead at
        construction (conn is None) are skipped — re-dialing them here
        would stall every refresh by their connect window; the failover
        loop re-dials them when the map actually routes there."""
        advanced = False
        with self._conns_lock:
            live = [ep for ep, c in self._conns.items() if c is not None]
        for ep in live:
            try:
                md = self._conn(ep).call("get_shard_map", _timeout=5.0)
            except (RuntimeError, ConnectionError, OSError):
                continue
            if self._adopt(md):
                advanced = True
        return advanced

    def _conn(self, ep):
        with self._conns_lock:
            c = self._conns.get(ep)
        if c is not None:
            return c
        # re-dial a previously-dead initial endpoint, or dial a server
        # that joined after this client was built (rejoin on a fresh
        # endpoint) — short window: failover handles failure. The dial
        # runs OUTSIDE the lock (it can block for the connect window);
        # a racing dial for the same endpoint keeps the first winner.
        c = Connection(ep, **{**self._rpc_opts,
                              "connect_retry_s": 2.0,
                              "fail_fast_refused": True})
        with self._conns_lock:
            cur = self._conns.get(ep)
            if cur is not None:
                won = cur
            else:
                won = self._conns[ep] = c
        if won is not c:
            c.close()
        return won

    def _drop_conn(self, ep):
        with self._conns_lock:
            c = self._conns.pop(ep, None)
        if c is not None:
            c.close()

    # ------------------------------------------------- replay identity
    def replay_state(self):
        """The (client_id, seq) replay identity, checkpointable: a
        restarted trainer that restores this and re-sends its
        in-doubt mutations under the SAME keys dedupes server-side
        across process death — exactly-once survives SIGKILL, not just
        lost responses (docs/fault_tolerance.md "Trainer recovery")."""
        with self._seq_lock:
            return {"client_id": self._client_id, "seq": int(self._seq)}

    def load_replay_state(self, state):
        cid = state["client_id"]
        if isinstance(cid, (bytes, np.ndarray)):
            cid = np.asarray(cid, np.uint8).tobytes().decode("ascii")
        with self._seq_lock:
            self._client_id = str(cid)
            self._seq = int(state.get("seq", 0))

    def _next_rid(self, key=None):
        if key is not None:
            return (self._client_id, key)
        with self._seq_lock:
            self._seq += 1
            return (self._client_id, self._seq)

    def _routed(self, shard, method, _mutating=False, _key=None,
                _timeout=None, **kw):
        """One logical call against a shard's primary, riding out stale
        maps and dead endpoints. The replay id is minted HERE, once, so
        every re-route of this call carries the same identity."""
        rid = self._next_rid(_key) if _mutating else None
        attempts = int(_flag("PADDLE_PS_FAILOVER_RETRIES")) + 1
        backoff = float(_flag("PADDLE_PS_FAILOVER_BACKOFF_S"))
        last = None
        for attempt in range(attempts):
            m = self._map
            ep = m.primary(shard)
            try:
                return self._conn(ep).call(
                    method, _mutating=_mutating, _rid=rid,
                    _timeout=_timeout, __epoch__=m.epoch,
                    __shard__=int(shard), **kw)
            except ShardMapStale as e:
                _monitor.stat_add("ps.replica.stale_maps")
                last = e
                if not self._adopt(e.shard_map_dict):
                    # the server is BEHIND us — teach it our map, then
                    # retry (it may still be the right primary)
                    try:
                        self._conn(ep).call(
                            "install_shard_map",
                            shard_map=self._map.to_dict())
                    except (RuntimeError, ConnectionError, OSError):
                        pass
            except (ConnectRefused, ConnectionError, OSError) as e:
                last = e
                self._drop_conn(ep)
                advanced = self.refresh_shard_map()
                # a parallel fan-out sibling (or a stale-map redirect on
                # another thread) may have adopted the post-promotion map
                # already: refresh reports no advance, but the shard no
                # longer routes HERE — that is a re-route, not a dead end
                moved = self._map.primary(shard) != ep
                if not advanced and not moved \
                        and not self._map.backups(shard):
                    # nowhere to fail over to (unreplicated map, or the
                    # shard lost its last backup): keep the transport's
                    # original fail-loud contract
                    raise
                if moved:
                    continue       # the new primary is live: no pacing
                if attempt < attempts - 1:
                    # a promotion needs a heartbeat deadline to pass —
                    # linear backoff paces the re-route loop across it
                    time.sleep(backoff * (1 + min(attempt, 3)))
        raise last

    @staticmethod
    def _rkey(request_key, method, table):
        # outer-retry-stable replay key: one merged batch can push several
        # tables (and both dense+sparse of the same name) to one server,
        # so the method and table disambiguate within the batch key.
        # Sharded calls add the shard so each slice applies once.
        return None if request_key is None else (request_key, method, table)

    # --------------------------------------------------------------- dense
    def pull_dense(self, table):
        shard = self._map.shard_of_name(table)
        return self._routed(shard, "pull_dense", table=table)

    def push_dense_grad(self, table, grad, request_key=None):
        shard = self._map.shard_of_name(table)
        self._routed(shard, "push_dense_grad", _mutating=True,
                     _key=self._rkey(request_key, "pdg", table),
                     table=table, grad=np.asarray(_host(grad), np.float32))

    def set_dense(self, table, value):
        shard = self._map.shard_of_name(table)
        self._routed(shard, "set_dense", _mutating=True, table=table,
                     value=np.asarray(_host(value), np.float32))

    # -------------------------------------------------------------- sparse
    def _fanout(self, shards, call_one):
        """Run call_one(shard) for every shard in `shards` — in parallel
        from the fan-out pool when there is more than one shard (a batch
        costs max(shard latency), not the sum), serially otherwise or
        when PADDLE_PS_FANOUT_THREADS is 1. Shard slices are disjoint,
        so results are bitwise-independent of the execution order.

        READS ONLY. Mutations keep the serial per-shard loop: a primary
        holds its per-table gate across the synchronous forward to its
        backups, so one client pushing several shard chains CONCURRENTLY
        can close a circular wait across the chained cluster (server i
        holds its gate waiting on server i+1, whose handler waits on the
        gate... all the way around). Serial pushes make that cycle
        impossible by construction — a client never holds two chains."""
        n_threads = int(_flag("PADDLE_PS_FANOUT_THREADS"))
        if len(shards) <= 1 or n_threads <= 1:
            for s in shards:
                call_one(int(s))
            return
        with self._fanout_lock:
            if self._fanout_pool is None:
                self._fanout_pool = ThreadPoolExecutor(
                    max_workers=n_threads,
                    thread_name_prefix="ps-client-fanout")
            pool = self._fanout_pool
        futures = [pool.submit(call_one, int(s)) for s in shards]
        err = None
        for f in futures:
            try:
                f.result()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err = err or e
        if err is not None:
            raise err

    def pull_sparse(self, table, ids):
        """Gather rows for (possibly duplicated) ids; returns
        [len(ids), dim] in input order. Reads always hit the primary.

        The batch is deduped BEFORE the wire (`SparseTable._ensure`'s
        order-preserving dedupe generalized to the cross-shard
        scatter/gather): a batch like [5, 9, 5] costs one row per shard
        regardless of routing, and the per-shard slices fan out in
        parallel (PADDLE_PS_FANOUT_THREADS). The inverse mapping gathers
        unique rows back to input positions, so the caller sees exactly
        the legacy per-position contract."""
        ids_in = np.asarray(_host(ids), np.int64).reshape(-1)
        if ids_in.size == 0:
            # empty batch: route like a dense table (any shard can
            # answer) so the caller still gets a [0, dim]-shaped block
            shard = self._map.shard_of_name(table)
            return np.asarray(self._routed(shard, "pull_sparse",
                                           table=table, ids=ids_in),
                              np.float32)
        uniq, inv = np.unique(ids_in, return_inverse=True)
        _monitor.stat_add("ps.client.pull_ids", int(ids_in.size))
        _monitor.stat_add("ps.client.pull_unique_rows", int(uniq.size))
        uniq, owner = self._map.shard_of_ids(uniq)
        shards = np.unique(owner)
        per_shard: dict[int, np.ndarray] = {}

        def pull_one(s):
            rows = np.asarray(self._routed(int(s), "pull_sparse",
                                           table=table,
                                           ids=uniq[owner == s]),
                              np.float32)
            _monitor.stat_add("ps.client.pull_rpcs")
            per_shard[s] = rows     # disjoint keys: no cross-thread race

        self._fanout(shards, pull_one)
        dim = next(iter(per_shard.values())).shape[1]
        out = np.empty((len(uniq), dim), np.float32)
        for s, rows in per_shard.items():
            out[owner == s] = rows
        return out[inv]

    def push_sparse_grad(self, table, ids, grads, request_key=None):
        """Duplicate ids are MERGED client-side before the wire
        (reference MergeAdd over SelectedRows), bitwise-identical to the
        server-side merge it used to ride: np.unique yields the same
        sorted unique set and np.add.at accumulates rows in the same
        input order either side of the wire."""
        ids, owner, merged = self._merged(ids, grads)
        if ids is None:
            return

        for s in np.unique(owner):
            mask = owner == s
            key = self._rkey(request_key, "psg", table)
            self._routed(int(s), "push_sparse_grad", _mutating=True,
                         _key=None if key is None else key + (int(s),),
                         table=table, ids=ids[mask], grads=merged[mask])

    def push_sparse_delta(self, table, ids, deltas, request_key=None):
        ids, owner, merged = self._merged(ids, deltas)
        if ids is None:
            return

        for s in np.unique(owner):
            mask = owner == s
            key = self._rkey(request_key, "psd", table)
            self._routed(int(s), "push_sparse_delta", _mutating=True,
                         _key=None if key is None else key + (int(s),),
                         table=table, ids=ids[mask], deltas=merged[mask])

    def _merged(self, ids, grads):
        """(unique ids, owner shards, merged grads) for a sparse push —
        (None, None, None) for an empty batch (nothing to send)."""
        ids = np.asarray(_host(ids), np.int64).reshape(-1)
        if ids.size == 0:
            return None, None, None
        grads = np.asarray(_host(grads), np.float32).reshape(len(ids), -1)
        uniq, inv = np.unique(ids, return_inverse=True)
        if len(uniq) != len(ids):
            merged = np.zeros((len(uniq), grads.shape[1]), np.float32)
            np.add.at(merged, inv, grads)
        else:
            merged = grads[np.argsort(ids, kind="stable")]
        uniq, owner = self._map.shard_of_ids(uniq)
        return uniq, owner, merged

    # --------------------------------------------------------------- misc
    def barrier(self, table, trainer_id, timeout=120.0):
        # the barrier table routes like a dense table — owned by its
        # shard's primary (it used to pin server 0: a SPOF the shard map
        # now owns). The RPC deadline must outlast the barrier's own
        # server-side wait or every long barrier would look stalled.
        shard = self._map.shard_of_name(table)
        return self._routed(shard, "barrier", _mutating=True,
                            _timeout=float(timeout) + 30.0,
                            table=table, trainer_id=trainer_id,
                            timeout=timeout)

    def ping(self):
        """Probe every server's transport (pre-auth health method);
        returns one latency in seconds per endpoint — None for a dead
        endpoint instead of raising, so supervisors see per-server
        health even mid-outage."""
        out = []
        for ep in self.endpoints:
            t0 = time.perf_counter()
            try:
                self._conn(ep).ping(timeout=5.0)
                out.append(time.perf_counter() - t0)
            except (ConnectionError, OSError):
                self._drop_conn(ep)
                out.append(None)
        return out

    def table_state(self, table, server=0):
        return self._server_conn(server).call("table_state", table=table)

    def table_applied(self, table, server=0):
        """How many mutating pushes a server's table has APPLIED (replayed
        retries don't count) — the observable for exactly-once tests."""
        return self._server_conn(server).call("table_applied", table=table)

    def _server_conn(self, server):
        return self._conn(self.endpoints[server])

    def save_snapshot(self, path):
        """Ask every server to snapshot its tables to server-local disk
        (file per server: {path}.s{i}); mid-train fault tolerance
        (reference large_scale_kv.h checkpointing)."""
        return [self._server_conn(i).call("save_snapshot",
                                          path=f"{path}.s{i}")
                for i in range(len(self.endpoints))]

    def load_snapshot(self, path):
        return [self._server_conn(i).call("load_snapshot",
                                          path=f"{path}.s{i}")
                for i in range(len(self.endpoints))]

    def stop_servers(self):
        for ep in {*self.endpoints, *self._map.servers}:
            try:
                self._conn(ep).call("stop")
            except (ConnectionError, OSError):
                pass

    def close(self):
        self._listeners.clear()
        with self._fanout_lock:
            pool, self._fanout_pool = self._fanout_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            if c is not None:
                c.close()


class Communicator:
    """Async gradient channel (reference communicator.cc AsyncCommunicator:
    per-var bounded queues, a background thread that MERGES queued grads
    — MergeAdd for sparse — and sends every batch; workers never block on
    the push). flush() drains synchronously; used at barriers/epoch ends.
    """

    def __init__(self, client: PSClient, send_every=4, max_queue=64,
                 max_delay_s=0.05):
        self._client = client
        self._send_every = int(send_every)
        self._max_delay_s = float(max_delay_s)
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        # per-merged-batch replay key: outer send retries reuse it, so a
        # batch that half-landed (server 0 applied, server 1 reset) is
        # finished rather than double-applied on the servers that took
        # it. Namespaced by a per-Communicator id — batch numbers restart
        # at 1 in every instance, and two communicators over one client
        # must not collide in the server's replay cache
        self._comm_id = uuid.uuid4().hex[:16]
        self._batch_no = 0
        self._keyed = bool(getattr(client, "supports_request_keys", False))
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _check_alive(self):
        """Surface a background send failure to the caller instead of the
        r03 failure mode: thread dies silently, queue fills, push_* blocks
        forever in Queue.put."""
        if self._error is not None:
            raise RuntimeError(
                "ps communicator send thread died") from self._error
        if not self._thread.is_alive() and not self._stop.is_set():
            raise RuntimeError("ps communicator send thread is not running")

    def _put(self, item):
        self._check_alive()
        while True:
            try:
                self._q.put(item, timeout=1.0)
                return
            except queue.Full:
                self._check_alive()   # don't hang on a dead consumer

    def push_sparse(self, table, ids, grads):
        self._put(("sparse", table,
                   np.asarray(_host(ids), np.int64).reshape(-1),
                   np.asarray(_host(grads), np.float32)))

    def push_dense(self, table, grad):
        self._put(("dense", table, None,
                   np.asarray(_host(grad), np.float32)))

    # --------------------------------------------------------- background
    def _loop(self):
        # drain-tracking rides the queue's task accounting: task_done only
        # fires AFTER a batch lands on the servers, so flush()'s join-style
        # wait can't slip past a produced-but-unsent item (an Event toggled
        # on a momentary empty poll could)
        pending = []
        first_ts = None
        try:
            while not self._stop.is_set() or not self._q.empty() or pending:
                try:
                    pending.append(self._q.get(timeout=0.05))
                    if first_ts is None:
                        first_ts = time.monotonic()
                except queue.Empty:
                    pass
                # batch trigger: enough items for a merge, a stop/drain, or
                # the oldest item aging past max_delay — NOT momentary
                # queue emptiness, which under normal pacing fires every
                # iteration and defeats send_every/MergeAdd batching
                aged = (first_ts is not None
                        and time.monotonic() - first_ts >= self._max_delay_s)
                if pending and (len(pending) >= self._send_every
                                or self._stop.is_set() or aged):
                    try:
                        self._send_with_retry(pending)
                    finally:
                        for _ in pending:
                            self._q.task_done()
                    pending = []
                    first_ts = None
        except BaseException as e:  # noqa: BLE001 — re-raised to callers
            self._error = e
            # the send thread is the PS stack's pulse: its death is a
            # transport death — flight-record the span/metric history
            # (no-op unless PADDLE_TPU_DUMP_DIR is set)
            from ...core import flight_recorder as _fr
            _fr.dump("ps_communicator_death", e)
            # NOTE: _send_merged's finally already task_done'd `pending`;
            # only drain what's still queued so flush() raises instead of
            # timing out (double-accounting raises 'task_done called too
            # many times')
            while True:
                try:
                    self._q.get_nowait()
                    self._q.task_done()
                except queue.Empty:
                    break

    def _send_with_retry(self, items):
        """One more layer of patience on top of the per-call transport
        retries: back off and re-send the merged batch (under its stable
        replay key — exactly-once holds across these retries too) before
        declaring the send thread dead."""
        self._batch_no += 1
        key = (self._comm_id, self._batch_no) if self._keyed else None
        attempts = int(_flag("PADDLE_PS_SEND_RETRIES")) + 1
        backoff = float(_flag("PADDLE_PS_BACKOFF_BASE_S"))
        ceiling = float(_flag("PADDLE_PS_BACKOFF_MAX_S"))
        from ...core import flight_recorder as _fr
        for attempt in range(attempts):
            try:
                with _trace.span("ps.comm/send_batch", items=len(items),
                                 batch_no=self._batch_no,
                                 attempt=attempt):
                    if attempt < attempts - 1:
                        # this layer will retry: an inner per-call
                        # exhaustion is not yet transport death — only
                        # the LAST attempt may declare it
                        with _fr.suppressed("ps_transport_death"):
                            self._send_merged(items, key)
                    else:
                        self._send_merged(items, key)
                return
            except OSError:
                # ConnectionError / DeadlineExceeded / FrameError — the
                # transport already burned its own retry budget
                if attempt == attempts - 1:
                    raise
                _monitor.stat_add("ps.communicator.send_retries")
                # 4x the transport's base so the outer layer backs off
                # slower than the inner one, same configurable ceiling
                time.sleep(min(ceiling, backoff * (2 ** attempt) * 4))

    def _send_merged(self, items, request_key=None):
        sparse: dict[str, list] = {}
        dense: dict[str, np.ndarray] = {}
        for kind, table, ids, grads in items:
            if kind == "sparse":
                sparse.setdefault(table, []).append((ids, grads))
            else:
                if table in dense:
                    dense[table] = dense[table] + grads
                else:
                    dense[table] = grads
        kw = {"request_key": request_key} if self._keyed else {}
        for table, parts in sparse.items():
            ids = np.concatenate([p[0] for p in parts])
            grads = np.concatenate(
                [p[1].reshape(len(p[0]), -1) for p in parts])
            # duplicate merging (reference MergeAdd) happens ONCE, in
            # PSClient._merged, before the wire — not re-implemented here
            self._client.push_sparse_grad(table, ids, grads, **kw)
        for table, grad in dense.items():
            self._client.push_dense_grad(table, grad, **kw)

    def flush(self, timeout=60.0):
        deadline = time.monotonic() + timeout
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                if self._error is not None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("communicator failed to drain")
                self._q.all_tasks_done.wait(min(remaining, 0.5))
        self._check_alive()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60.0)
        if self._error is not None:
            raise RuntimeError(
                "ps communicator send thread died") from self._error
