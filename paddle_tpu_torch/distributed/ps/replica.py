"""Primary–backup replication manager for the PS storage tier
(paddle_tpu/distributed/ps/replica.py, whole; the port's own copy).

The transport (rpc.py) is exactly-once under chaos; this module makes
the *storage* survive a permanent server death (the TensorFlow paper
treats PS replication/recovery as table stakes). One
``ReplicaManager`` rides inside every ``PSServer`` of a replicated
cluster and owns four protocols:

**Routing** (`check`): every shard-map-routed request carries the
client's map epoch (+ target shard). An epoch mismatch or a write aimed
at a non-primary raises ``ShardMapStale`` carrying the server's current
map — the redirect is never cached in the replay cache (the same replay
id must still run for real on the right server) and costs the client one
round trip.

**Replication** (`record_and_forward`): a primary applies a mutation
locally, stamps it with a per-table sequence number into a bounded
replay-keyed delta log, then *synchronously* forwards it to every live
backup under the ORIGINAL client replay id — so a client retry after the
primary dies dedupes on the backup against the forward that already
landed (the exactly-once keystone of failover), and a forward retry
dedupes against itself via the backup's ReplayCache. Apply+log+forward
run under a per-table gate, which keeps per-table forwards in sequence
order over the serialized per-backup connection. The ack returns to the
client only once the write is durable on the quorum
(``PADDLE_PS_REPLICA_QUORUM``, 0 = every live replica); an unreachable
backup is evicted from the map (epoch bump, broadcast) rather than
wedging writes.

**Failure detection** (`_beat_loop`/`_watch_loop`): every server beats
``replica_beat`` into its peers every ``PADDLE_PS_HEARTBEAT_S``; a
primary whose beats stop for ``PADDLE_PS_HEARTBEAT_TIMEOUT_S`` is
suspected, and the FIRST live backup of each of its shards promotes
itself: installs ``map.without(dead)`` (epoch+1) and broadcasts it.
Epochs resolve races — newer maps win everywhere, and beat replies carry
epochs so a behind server fetches the current map. A deposed primary
that still tries to forward gets a ``ShardMapStale`` from its backups,
adopts the new map, and surfaces the redirect to its client instead of
acking a write that is durable nowhere that serves.

**Rejoin/catch-up** (`rejoin`/`fetch`/`attach`): a restarted (or
falsely-evicted) server pulls each table's full snapshot + sequence
cursor from the new primary (`replica_fetch`), then attaches
(`replica_attach`): the primary — holding every table gate so the cutoff
is exact — adds it to the map as a backup and hands back the delta-log
suffix past the snapshot cursor. The rejoiner applies those deltas
through the replay cache under their original rids while incoming live
forwards PARK on the catch-up event, so deltas and forwards interleave
exactly once and in order. A cursor that has fallen off the bounded log
(``PADDLE_PS_REPLICA_DELTA_LOG``) answers ``restart`` and the rejoiner
re-fetches.

Observability: counters ``ps.replica.{forwards,promotions,catchups,
stale_maps,forward_failures,evictions}`` (stale_maps is bumped by the
client on redirect) and spans ``ps.replica/{forward,promote,catchup}``
cover every hop; all knobs are ``PADDLE_PS_REPLICA_*`` /
``PADDLE_PS_HEARTBEAT_*`` flags.

Scope: single-failure-at-a-time tolerance per shard (classic
primary–backup without consensus — concurrent epoch bumps for the SAME
epoch are resolved arbitrarily by arrival order, which cannot happen in
the chained default layout where each server primaries exactly one
shard). Barrier tables are routed by the map but not replicated (their
state is a transient rendezvous, not training state).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ...core import monitor as _monitor
from ...core import trace as _trace
from ...core.flags import flag as _flag
from .rpc import Connection
from .shard_map import ShardMap, ShardMapStale

__all__ = ["ReplicaManager", "ReplayUncacheable", "REPLICATED_MUTATIONS"]

# table mutations that replicate (barrier excluded by design) — the
# single source of truth; PSServer._handle imports it to decide which
# methods run under the gate+forward path
REPLICATED_MUTATIONS = frozenset({
    "push_dense_grad", "set_dense", "push_sparse_grad",
    "push_sparse_delta"})


class ReplayUncacheable(RuntimeError):
    """A replication error whose reply must NOT be committed to the
    replay cache: the same rid is expected to run for real on a retry
    (rpc._serve_one aborts the rid instead — a cached error would
    replay forever and permanently poison the client's replay key)."""

    replay_uncacheable = True


def _filter_sparse_state(st, shard, n_shards):
    """Restrict a SparseTable state dict to the rows of one shard —
    catch-up transfers one shard at a time, and a primary's table also
    holds rows of OTHER shards it backs (or once served); leaking those
    into a rejoiner could shadow fresher rows it synced elsewhere."""
    ids = np.asarray(st["ids"], np.int64).reshape(-1)
    mask = (ids % np.int64(n_shards)) == shard
    keep = ids[mask]
    values = np.asarray(st["values"], np.float32)
    if len(ids):
        values = values.reshape(len(ids), -1)[mask]
    kept = {int(i) for i in keep}
    slots = {i: s for i, s in (st.get("slots") or {}).items()
             if int(i) in kept}
    return {"ids": keep, "values": values, "lr": st["lr"], "slots": slots}


class ReplicaManager:
    def __init__(self, server, endpoint, shard_map=None, peers=None,
                 n_backups=None, heartbeat_s=None, heartbeat_timeout_s=None,
                 rpc_opts=None, rejoin=True):
        """server: the owning PSServer (started; tables + replay cache
        live there). shard_map: initial ShardMap/dict; a rejoining server
        passes None + `peers` (live endpoints to learn the map from).
        rpc_opts: Connection overrides for forward channels (tests pass
        fast timeouts)."""
        self._server = server
        self.endpoint = endpoint
        self._peers = list(peers or ())
        self._n_backups = int(_flag("PADDLE_PS_REPLICA_BACKUPS")
                              if n_backups is None else n_backups)
        self._hb_s = float(_flag("PADDLE_PS_HEARTBEAT_S")
                           if heartbeat_s is None else heartbeat_s)
        self._hb_timeout = float(_flag("PADDLE_PS_HEARTBEAT_TIMEOUT_S")
                                 if heartbeat_timeout_s is None
                                 else heartbeat_timeout_s)
        self._rpc_opts = dict(rpc_opts or {})
        self._rejoin_enabled = bool(rejoin)

        self._map_lock = threading.RLock()
        if shard_map is None:
            self._map = ShardMap.default([endpoint])
            self._needs_bootstrap = bool(self._peers)
        else:
            self._map = shard_map if isinstance(shard_map, ShardMap) \
                else ShardMap.from_dict(shard_map)
            self._needs_bootstrap = False

        # per-table: apply+log+forward gate, mutation cursor, delta log
        self._gates: dict[str, threading.Lock] = {}
        self._gates_lock = threading.Lock()
        self._seq: dict[str, int] = {}
        self._dlog: dict[str, deque] = {}

        # catch-up parking: forwards for these tables wait until the
        # delta suffix has been applied, preserving sequence order
        self._catching_up: set[str] = set()
        self._catchup_done = threading.Event()
        self._catchup_done.set()

        # membership view
        self._last_beat: dict[str, float] = {}
        self._started_at = time.monotonic()

        # data (forward) and beat connections, separate so a large
        # forward can't delay a heartbeat into a false suspicion
        self._conns_lock = threading.Lock()
        self._data_conns: dict[str, Connection] = {}
        self._beat_conns: dict[str, Connection] = {}

        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._beat_loop, daemon=True,
                             name=f"ps-replica-beat@{endpoint}"),
            threading.Thread(target=self._watch_loop, daemon=True,
                             name=f"ps-replica-watch@{endpoint}"),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ helpers
    @property
    def shard_map(self) -> ShardMap:
        return self._map

    def map_dict(self):
        return self._map.to_dict()

    def replicates(self, table_name):
        t = self._server._tables.get(table_name)
        return t is not None and hasattr(t, "state")

    def _replicated_tables(self):
        return sorted(n for n in self._server._tables
                      if self.replicates(n))

    def gate(self, table):
        with self._gates_lock:
            g = self._gates.get(table)
            if g is None:
                g = self._gates[table] = threading.Lock()
            return g

    def _conn(self, pool, ep, **extra):
        with self._conns_lock:
            c = pool.get(ep)
            if c is None:
                opts = dict(self._rpc_opts)
                opts.update(extra)
                c = pool[ep] = Connection(ep, **opts)
            return c

    def _data_conn(self, ep):
        return self._conn(self._data_conns, ep, fail_fast_refused=True)

    def _beat_conn(self, ep):
        return self._conn(self._beat_conns, ep,
                          timeout=min(2.0, self._hb_timeout),
                          max_retries=0, connect_retry_s=0.5,
                          fail_fast_refused=True)

    def _drop_conn(self, ep):
        with self._conns_lock:
            for pool in (self._data_conns, self._beat_conns):
                c = pool.pop(ep, None)
                if c is not None:
                    c.close()

    # --------------------------------------------------------- map install
    def install(self, map_dict, broadcast=False):
        """Adopt a map if it is newer than ours. Returns True on adopt."""
        new = map_dict if isinstance(map_dict, ShardMap) \
            else ShardMap.from_dict(map_dict)
        with self._map_lock:
            if new.epoch <= self._map.epoch:
                return False
            self._map = new
        if broadcast:
            self._broadcast(new)
        return True

    def _install_bumped(self, new: ShardMap):
        with self._map_lock:
            if new.epoch <= self._map.epoch:
                return False
            self._map = new
        self._broadcast(new)
        return True

    def _broadcast(self, new: ShardMap):
        """Best-effort push of a new map to every member + known peer —
        redirects and beat-epoch gossip cover anyone missed here."""
        d = new.to_dict()
        for ep in {*new.servers, *self._peers} - {self.endpoint}:
            try:
                self._beat_conn(ep).call("install_shard_map", shard_map=d)
            except (ConnectionError, OSError):
                pass

    # ------------------------------------------------------- request path
    def check(self, method, req):
        """Routing check, called by PSServer._handle before any apply.
        Pops the routing keys; returns (shard, is_forward). Raises
        ShardMapStale on an epoch/primary mismatch."""
        shard = req.pop("__shard__", None)
        fwd_epoch = req.pop("__fwd__", None)
        epoch = req.pop("__epoch__", None)
        m = self._map
        if fwd_epoch is not None:
            # a forward from a primary. A deposed primary (older epoch)
            # must not smuggle writes past a promotion — teach it.
            if fwd_epoch < m.epoch:
                raise ShardMapStale(m.to_dict(),
                                    "forward from a deposed primary")
            self._park_if_catching_up(req.get("table"))
            return shard, True
        if epoch is None:
            return shard, False        # legacy/unrouted client: no checks
        if epoch != m.epoch:
            raise ShardMapStale(
                m.to_dict(), f"client epoch {epoch} != server {m.epoch}")
        if shard is not None and m.primary(shard) != self.endpoint:
            raise ShardMapStale(
                m.to_dict(), f"{self.endpoint} is not primary of shard "
                             f"{shard}")
        return shard, False

    def _park_if_catching_up(self, table):
        """Forwards for a table mid-catch-up wait until its delta suffix
        has been applied — sequence order is preserved end to end. A
        catch-up that outlasts the park window fails the forward LOUDLY
        (the primary's quorum/eviction path deals with it) instead of
        letting it apply ahead of earlier-sequenced suffix entries."""
        if table in self._catching_up:
            if not self._catchup_done.wait(timeout=30.0):
                raise ReplayUncacheable(
                    f"ps replica: forward for table {table!r} parked "
                    ">30s behind an unfinished catch-up")

    def seen(self, table, rid):
        """Is `rid` already in `table`'s delta log? True means this
        exact mutation was applied+logged here before — a retry of a
        quorum-failed call must re-FORWARD it but never re-APPLY it."""
        if rid is None:
            return False
        log = self._dlog.get(table)
        if not log:
            return False
        rid = tuple(rid)
        return any(e[1] is not None and tuple(e[1]) == rid for e in log)

    def record_and_forward(self, table, shard, method, req, rid,
                           is_forward, log_entry=True):
        """Called under gate(table), AFTER the local apply: stamp the
        mutation into the delta log; when acting as primary, forward it
        to every live backup under the original rid and enforce the
        write quorum. `log_entry=False` skips the apply-side bookkeeping
        for a quorum-failure retry whose mutation is already logged —
        only the forward + quorum check re-run."""
        m = self._map
        if shard is None:
            ids = req.get("ids")
            if ids is not None and np.asarray(ids).size:
                shard = int(np.asarray(ids).reshape(-1)[0]) % m.n_shards
            else:
                shard = m.shard_of_name(table)
        if log_entry:
            seq = self._seq[table] = self._seq.get(table, 0) + 1
            log = self._dlog.get(table)
            if log is None:
                log = self._dlog[table] = deque(
                    maxlen=max(1,
                               int(_flag("PADDLE_PS_REPLICA_DELTA_LOG"))))
            log.append((seq, rid, method, dict(req), int(shard)))
        if is_forward:
            return
        backups = [b for b in m.backups(shard) if b != self.endpoint]
        acked = 1                              # self
        for b in backups:
            with _trace.span("ps.replica/forward", table=table,
                             shard=shard, backup=b, method=method,
                             epoch=m.epoch):
                try:
                    kw = {"_rid": rid} if rid is not None else {}
                    self._data_conn(b).call(
                        method, _mutating=True, __fwd__=m.epoch,
                        table=table, **kw, **req)
                    _monitor.stat_add("ps.replica.forwards")
                    acked += 1
                except ShardMapStale as e:
                    # the backup knows a newer world: we were deposed.
                    # Adopt, and DO NOT ack — re-raise so the client
                    # re-pushes (same rid) to the real primary.
                    _monitor.stat_add("ps.replica.forward_failures")
                    self.install(e.shard_map_dict)
                    raise
                except (ConnectionError, OSError):
                    _monitor.stat_add("ps.replica.forward_failures")
                    self._evict(b)
        quorum = int(_flag("PADDLE_PS_REPLICA_QUORUM"))
        if quorum and acked < quorum:
            # already applied+logged locally, so the rid must stay
            # retryable: ReplayUncacheable makes serve() abort it, and
            # the retry re-enters through seen() — forward-only, no
            # second apply — once a backup rejoins or is evicted
            raise ReplayUncacheable(
                f"ps replica: write quorum not met for {table!r}: "
                f"{acked}/{quorum} replicas acked")

    def _evict(self, ep):
        """Remove an unreachable member from the map (epoch bump +
        broadcast). Its state is NOT lost if it comes back — it rejoins
        through catch-up like any restarted server."""
        with self._map_lock:
            if ep not in self._map.servers:
                return
            new = self._map.without(ep)
            self._map = new
        self._drop_conn(ep)
        _monitor.stat_add("ps.replica.evictions")
        self._broadcast(new)

    # ----------------------------------------------------------- liveness
    def on_beat(self, from_ep, epoch):
        self._last_beat[from_ep] = time.monotonic()
        return {"epoch": self._map.epoch}

    def _beat_loop(self):
        while not self._stop.wait(self._hb_s):
            m = self._map
            mine = m.epoch
            for ep in {*m.servers, *self._peers} - {self.endpoint}:
                try:
                    r = self._beat_conn(ep).call(
                        "replica_beat", **{"from": self.endpoint,
                                           "epoch": mine})
                    peer_epoch = (r or {}).get("epoch", 0)
                    if peer_epoch > mine:
                        md = self._beat_conn(ep).call("get_shard_map")
                        if md:
                            self.install(md)
                    elif peer_epoch < mine:
                        self._beat_conn(ep).call(
                            "install_shard_map", shard_map=m.to_dict())
                except (ConnectionError, OSError):
                    pass
            if self._needs_bootstrap:
                self._bootstrap()

    def _alive(self, ep, now=None):
        if ep == self.endpoint:
            return True
        now = time.monotonic() if now is None else now
        last = self._last_beat.get(ep, self._started_at)
        return (now - last) < self._hb_timeout

    def _watch_loop(self):
        interval = max(0.05, self._hb_timeout / 4.0)
        while not self._stop.wait(interval):
            now = time.monotonic()
            m = self._map
            for shard in range(m.n_shards):
                primary = m.primary(shard)
                if primary == self.endpoint or self._alive(primary, now):
                    continue
                live_backups = [b for b in m.backups(shard)
                                if self._alive(b, now)]
                if live_backups and live_backups[0] == self.endpoint:
                    self._promote(primary)
            if self._rejoin_enabled and not self._needs_bootstrap \
                    and self.endpoint not in m.servers:
                # we were evicted (false suspicion or a lost race) —
                # our state may have diverged; re-enter via catch-up
                try:
                    self.rejoin()
                except (ConnectionError, OSError, RuntimeError):
                    pass

    def _promote(self, dead):
        with self._map_lock:
            if dead not in self._map.servers:
                return
            now = time.monotonic()
            new = self._map.without(dead)
            # a multi-failure window (primary AND its leading backups
            # dead past the deadline) must not install a corpse as
            # primary — without() promotes the first LISTED backup, so
            # sweep every dead member that would end up primarying a
            # shard in the same epoch window. Each pass removes >=1
            # server, so this terminates; tombstoned unrecoverable
            # primaries are already out of `servers` and stay listed.
            while True:
                stale = [ep for ep in new.servers
                         if ep != self.endpoint
                         and not self._alive(ep, now)
                         and new.shards_primaried_by(ep)]
                if not stale:
                    break
                for ep in stale:
                    new = new.without(ep)
            with _trace.span("ps.replica/promote", dead=dead,
                             new_epoch=new.epoch,
                             promoted=self.endpoint):
                self._map = new
        self._drop_conn(dead)
        _monitor.stat_add("ps.replica.promotions")
        self._broadcast(new)

    # ----------------------------------------------------- rejoin/catch-up
    def _bootstrap(self):
        """First map fetch for a server started with peers + no map."""
        best = None
        for ep in self._peers:
            if ep == self.endpoint:
                continue
            try:
                md = self._beat_conn(ep).call("get_shard_map")
            except (ConnectionError, OSError):
                continue
            if md and (best is None or md["epoch"] > best["epoch"]):
                best = md
        if best is None:
            return
        with self._map_lock:
            new = ShardMap.from_dict(best)
            if new.epoch >= self._map.epoch:
                self._map = new
        self._needs_bootstrap = False
        if self._rejoin_enabled and self.endpoint not in self._map.servers:
            try:
                self.rejoin()
            except (ConnectionError, OSError, RuntimeError):
                self._needs_bootstrap = True    # retry on the next beat

    def rejoin(self):
        """Re-enter the map as a backup of every under-replicated shard:
        snapshot + delta-log catch-up from each shard's primary."""
        m = self._map
        shards = [s for s in m.under_replicated(self._n_backups)
                  if m.primary(s) != self.endpoint
                  and self.endpoint not in m.backups(s)]
        if not shards:
            return False
        with _trace.span("ps.replica/catchup", shards=list(shards),
                         endpoint=self.endpoint):
            for shard in shards:
                self._catchup_shard(shard)
        _monitor.stat_add("ps.replica.catchups")
        return True

    def _catchup_shard(self, shard, max_rounds=3):
        primary = self._map.primary(shard)
        conn = self._data_conn(primary)
        tables = None
        for _round in range(max_rounds):
            snap = conn.call("replica_fetch")
            tables = sorted(snap)
            # load snapshots + cursors; park forwards until deltas land
            self._catchup_done.clear()
            self._catching_up.update(tables)
            n_shards = self._map.n_shards
            try:
                for t, entry in snap.items():
                    table = self._server._tables.get(t)
                    if table is None or not hasattr(table, "load_state"):
                        continue
                    st = entry["state"]
                    with self.gate(t):
                        if "ids" in st:        # sparse: merge one shard
                            table.load_state(_filter_sparse_state(
                                st, int(shard), n_shards), merge=True)
                        elif self._map.shard_of_name(t) == int(shard):
                            table.load_state(st)   # dense of this shard
                        else:
                            continue           # dense of another shard
                        self._seq[t] = max(self._seq.get(t, 0),
                                           int(entry["seq"]))
                        self._dlog.pop(t, None)
                        # snapshot-covered rids of THIS shard: a late
                        # forward-retry must replay, not re-apply
                        replay = getattr(self._server, "replay", None)
                        if replay is not None:
                            for rid, rshard in entry.get("rids", ()):
                                if int(rshard) != int(shard):
                                    continue
                                state, _ = replay.begin(tuple(rid))
                                if state == "run":
                                    replay.commit(tuple(rid),
                                                  {"result": True})
                reply = conn.call(
                    "replica_attach", _mutating=True,
                    endpoint=self.endpoint, shard=int(shard),
                    seqs={t: int(snap[t]["seq"]) for t in snap})
                if reply.get("restart"):
                    continue        # cursor fell off the bounded log
                self.install(reply["shard_map"])
                self._apply_deltas(reply.get("deltas", {}))
                return True
            finally:
                self._catching_up.difference_update(tables or ())
                self._catchup_done.set()
        raise RuntimeError(
            f"ps replica: catch-up for shard {shard} kept missing the "
            f"delta log after {max_rounds} rounds "
            "(PADDLE_PS_REPLICA_DELTA_LOG too small for the write rate?)")

    def _apply_deltas(self, deltas):
        """Apply the attach delta suffix through the replay cache under
        each entry's ORIGINAL rid, so live forwards (and client retries)
        arriving later dedupe against it."""
        replay = getattr(self._server, "replay", None)
        for t, entries in deltas.items():
            table = self._server._tables.get(t)
            if table is None:
                continue
            for seq, rid, method, payload in entries:
                run = True
                if rid is not None and replay is not None:
                    state, _payload = replay.begin(tuple(rid))
                    run = state == "run"
                if run:
                    with self.gate(t):
                        self._server._apply_table_op(table, method,
                                                     dict(payload))
                        self._seq[t] = max(self._seq.get(t, 0), int(seq))
                    if rid is not None and replay is not None:
                        replay.commit(tuple(rid), {"result": True})

    # ----------------------------------------------- primary-side handlers
    def fetch(self):
        """replica_fetch: per-table consistent (state, cursor) pairs,
        plus the (rid, shard) pairs currently in the delta log — their
        mutations are reflected in the snapshot, and the rejoiner
        registers them in its replay cache so a late forward-retry of
        one (a quorum-failed call) replays instead of re-applying on
        top of the snapshot."""
        out = {}
        for t in self._replicated_tables():
            table = self._server._tables[t]
            with self.gate(t):
                out[t] = {"state": table.state(),
                          "seq": int(self._seq.get(t, 0)),
                          "rids": [[e[1], e[4]]
                                   for e in self._dlog.get(t, ())
                                   if e[1] is not None]}
        return out

    def attach(self, endpoint, shard, seqs):
        """replica_attach: holding EVERY table gate (so the cutoff is
        exact), add the rejoiner to the map — forwards to it start the
        instant the gates release — and return the delta-log suffix past
        its snapshot cursors."""
        tables = self._replicated_tables()
        gates = [self.gate(t) for t in tables]
        for g in gates:
            g.acquire()
        try:
            shard = int(shard)
            deltas = {}
            for t in tables:
                cutoff = int(seqs.get(t, 0))
                cur = self._seq.get(t, 0)
                if cur <= cutoff:
                    deltas[t] = []
                    continue
                log = self._dlog.get(t, ())
                suffix = [e for e in log if e[0] > cutoff]
                # contiguity on the UNFILTERED log: a gap means the
                # bounded log already dropped entries the cursor needs
                if not suffix or suffix[0][0] != cutoff + 1:
                    return {"restart": True}
                deltas[t] = [(e[0], e[1], e[2], e[3]) for e in suffix
                             if e[4] == shard]
            with self._map_lock:
                new = self._map.with_backup(shard, endpoint)
                self._map = new
        finally:
            for g in gates:
                g.release()
        self._last_beat[endpoint] = time.monotonic()
        self._broadcast(new)
        return {"shard_map": new.to_dict(), "deltas": deltas}

    # -------------------------------------------------------------- admin
    def close(self):
        self._stop.set()
        self._catchup_done.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2.0)
        with self._conns_lock:
            for pool in (self._data_conns, self._beat_conns):
                for c in pool.values():
                    c.close()
                pool.clear()
