"""Versioned embedding snapshot publish — the train→serve half of the
online-learning loop (paddle_tpu/distributed/ps/publish.py, whole;
docs/online_learning.md).

The publish mechanism IS the replica tier's rejoin machinery reused
read-only: `replica_fetch` returns, per table, a gate-consistent
(state, seq) pair — every delta the primary acked is in the state, and
`seq` is the exact mutation cursor of the cut. The publisher walks the
shard map, fetches each shard's primary snapshot (riding the client's
failover re-route, so a mid-publish primary kill lands on the promoted
backup), filters the state to the rows the shard actually OWNS
(`_filter_sparse_state` — a primary's table also carries rows it backs
for others), and stamps the union with a monotonically increasing
version number.

The per-shard `seq` cursor is the publish-side cutoff: a shard whose
cursor has not moved since the last publish contributes its cached rows
without re-serializing the table — incremental publishes cost only the
shards that trained.

On every publish the attached `HeterPSCache` (if any) is invalidated —
the same protocol that covers membership changes covers a snapshot
becoming the served truth, so no cached pre-publish row can shadow it.

Unreplicated clusters (no `enable_replication`) degrade to
`table_state` per shard primary: same rows, no consistency gate and no
cutoff cursor (every publish refetches everything).
"""
from __future__ import annotations

import numpy as np

from .replica import _filter_sparse_state

__all__ = ["EmbeddingSnapshotPublisher"]


class EmbeddingSnapshotPublisher:
    """Publish versioned embedding snapshots out of a sharded PS table.

        pub = EmbeddingSnapshotPublisher(client, table="emb")
        version, rows = pub.publish()        # rows: {id: float32[dim]}
        serve_loop.publish_weights(version, {"wte.weight":
            pub.materialize(current_wte)})   # dense [vocab, dim]

    `cache=` takes the serving side's HeterPSCache; it is invalidated
    on every publish.
    """

    def __init__(self, client, table, cache=None, start_version=0):
        self.client = client
        self.table = str(table)
        self.cache = cache
        self.version = int(start_version)
        self._seqs = {}        # shard -> seq cursor of last fetch
        self._shard_rows = {}  # shard -> {id: row} as of that cursor
        self._rows = {}        # union of the last publish

    def publish(self):
        """Fetch every shard's consistent snapshot and cut a new
        version. Returns (version, {id: float32[dim] row}) — only ids
        the table has materialized appear. Raises if any shard is
        unreachable through failover (a half-fetched snapshot is never
        published)."""
        from ...core import monitor as _monitor
        from ...core import trace as _trace
        m = self.client._map
        rows = {}
        refetched = 0
        with _trace.span("ps/publish", table=self.table,
                         shards=m.n_shards):
            for shard in range(m.n_shards):
                entry, seq = self._fetch_shard(shard)
                if seq is not None and self._seqs.get(shard) == seq:
                    # cutoff cursor: nothing applied on that server
                    # since the last publish — reuse the cached rows
                    rows.update(self._shard_rows[shard])
                    continue
                st = _filter_sparse_state(entry, shard, m.n_shards)
                ids = np.asarray(st["ids"], np.int64).reshape(-1)
                vals = np.asarray(st["values"], np.float32)
                if ids.size:
                    vals = vals.reshape(ids.size, -1)
                shard_rows = {int(i): vals[k].copy()
                              for k, i in enumerate(ids)}
                self._shard_rows[shard] = shard_rows
                if seq is not None:
                    self._seqs[shard] = seq
                refetched += 1
                rows.update(shard_rows)
            self.version += 1
            self._rows = rows
            if self.cache is not None:
                self.cache.invalidate()
        _monitor.stat_add("ps.publish.publishes")
        _monitor.stat_add("ps.publish.shards_refetched", refetched)
        _monitor.stat_set_many({"ps.publish.version": self.version,
                                "ps.publish.rows": len(rows)})
        return self.version, rows

    def _fetch_shard(self, shard):
        """(table state, seq cursor) of one shard's primary. Rides
        `_routed` so a dead primary fails over to the promoted backup
        mid-publish; falls back to the ungated `table_state` (seq=None)
        when replication is off."""
        try:
            snap = self.client._routed(shard, "replica_fetch")
        except RuntimeError as e:
            if "replication" not in str(e):
                raise
            st = self.client._routed(shard, "table_state",
                                     table=self.table)
            return st, None
        entry = snap.get(self.table)
        if entry is None:
            raise KeyError(f"table {self.table!r} is not replicated on "
                           f"shard {shard}'s primary (got "
                           f"{sorted(snap)})")
        return entry["state"], int(entry["seq"])

    def materialize(self, base):
        """Dense [vocab, dim] matrix of the LAST published version:
        a copy of `base` (the currently served weights) with every
        published row overwritten — rows serve traffic never trained
        keep serving their current values."""
        out = np.array(base, np.float32)
        for i, row in self._rows.items():
            if 0 <= i < out.shape[0]:
                out[i] = row
        return out
