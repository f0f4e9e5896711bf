"""Versioned shard map for the replicated PS storage tier
(paddle_tpu/distributed/ps/shard_map.py, whole; pure Python, the port's
own copy).

Without it placement would be the fixed `id % n_servers` rule: every
shard on exactly one server, lost with it. This module makes placement an
explicit, versioned object (the reference's ps.proto table placement +
the TensorFlow paper's variable-placement maps play the same role):

- ``ShardMap``: shard -> primary endpoint + ordered backup endpoints,
  for sparse shards AND dense tables (dense tables hash onto shards with
  ``shard_of_name``; sparse ids with ``shard_of_id``). The *default* map
  (``ShardMap.default``) reproduces the legacy modulo routing bit-for-bit
  (n_shards == n_servers, shard i's primary is server i, no backups), so
  unreplicated clusters behave exactly as before.
- **Epoch**: every mutation of the map (promotion, eviction, backup
  attach) bumps a monotonically increasing epoch. Clients cache the map
  and stamp requests with their epoch; a server whose epoch differs
  answers with a ``ShardMapStale`` redirect carrying its own map instead
  of silently serving from (or applying to) the wrong placement. Newer
  epoch always wins on adoption, so maps gossip forward through
  redirects, heartbeats and install broadcasts.

The map is deliberately a plain-container value object (dict/list/str/
int only) so it can ride the restricted-unpickler RPC transport and be
compared/copied trivially.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["ShardMap", "ShardMapStale"]


class ShardMapStale(RuntimeError):
    """Routing rejection: the caller's shard-map epoch does not match the
    server's (or the server is not the primary the caller thinks it is).
    Carries the server's current map so one redirect round-trip is enough
    for the client to re-route. Never cached in the replay cache and
    never retried blindly by the transport — the *client* re-routes."""

    def __init__(self, map_dict, reason="shard map is stale"):
        epoch = (map_dict or {}).get("epoch")
        super().__init__(f"{reason} (server epoch {epoch})")
        self.shard_map_dict = map_dict


class ShardMap:
    """shard -> (primary, backups) placement, versioned by ``epoch``.

    ``shards`` is a list of ``{"primary": endpoint, "backups": [eps]}``;
    ``servers`` is the member list (stable construction order — clients
    keep using it for per-server admin fan-outs like snapshots)."""

    def __init__(self, shards, servers, epoch=0):
        self.shards = [{"primary": s["primary"],
                        "backups": list(s.get("backups", ()))}
                       for s in shards]
        self.servers = list(servers)
        self.epoch = int(epoch)

    # ------------------------------------------------------- constructors
    @classmethod
    def default(cls, endpoints):
        """Legacy-equivalent map: one shard per server, no backups. With
        this map every routing decision below reproduces the pre-replica
        `id % n_servers` / `crc32(name) % n_servers` rules exactly."""
        eps = list(endpoints)
        return cls([{"primary": ep, "backups": []} for ep in eps], eps, 0)

    @classmethod
    def create(cls, endpoints, n_backups=1):
        """Replicated map: shard i's primary is server i, its backups the
        next ``n_backups`` servers round-robin (the classic chained
        primary/backup layout — every server primaries one shard and
        backs up its neighbours'). Starts at epoch 1 so it strictly
        supersedes the synthetic epoch-0 default map a shard-map-naive
        client builds before asking the cluster."""
        eps = list(endpoints)
        n = len(eps)
        k = max(0, min(int(n_backups), n - 1))
        shards = [{"primary": eps[i],
                   "backups": [eps[(i + 1 + j) % n] for j in range(k)]}
                  for i in range(n)]
        return cls(shards, eps, 1)

    @classmethod
    def from_dict(cls, d):
        return cls(d["shards"], d["servers"], d.get("epoch", 0))

    def to_dict(self):
        return {"epoch": self.epoch,
                "servers": list(self.servers),
                "shards": [{"primary": s["primary"],
                            "backups": list(s["backups"])}
                           for s in self.shards]}

    # ------------------------------------------------------------ routing
    @property
    def n_shards(self):
        return len(self.shards)

    def primary(self, shard):
        return self.shards[int(shard)]["primary"]

    def backups(self, shard):
        return list(self.shards[int(shard)]["backups"])

    def members(self, shard):
        s = self.shards[int(shard)]
        return [s["primary"]] + list(s["backups"])

    def shard_of_id(self, i):
        return int(i) % self.n_shards

    def shard_of_ids(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        return ids, ids % np.int64(self.n_shards)

    def shard_of_name(self, name):
        # crc32, NOT hash(): str hash is per-process randomized and every
        # worker must route a dense/barrier table to the same shard
        return zlib.crc32(name.encode()) % self.n_shards

    # ------------------------------------------------------- reconfiguring
    def without(self, endpoint):
        """New map (epoch+1) with ``endpoint`` removed everywhere: shards
        it primaried promote their first surviving backup; shards it
        backed up just drop it. Shards with no surviving replica keep the
        dead primary listed (calls to them keep failing loudly rather
        than silently rehoming to an empty table)."""
        shards = []
        for s in self.shards:
            backups = [b for b in s["backups"] if b != endpoint]
            primary = s["primary"]
            if primary == endpoint:
                if backups:
                    primary = backups.pop(0)
                # else: unrecoverable shard; leave the tombstone primary
            shards.append({"primary": primary, "backups": backups})
        servers = [ep for ep in self.servers if ep != endpoint]
        return ShardMap(shards, servers, self.epoch + 1)

    def with_backup(self, shard, endpoint):
        """New map (epoch+1) with ``endpoint`` appended to ``shard``'s
        backups (rejoin/catch-up completion)."""
        shards = [{"primary": s["primary"], "backups": list(s["backups"])}
                  for s in self.shards]
        s = shards[int(shard)]
        if endpoint != s["primary"] and endpoint not in s["backups"]:
            s["backups"].append(endpoint)
        servers = list(self.servers)
        if endpoint not in servers:
            servers.append(endpoint)
        return ShardMap(shards, servers, self.epoch + 1)

    def under_replicated(self, n_backups):
        """Shard indices carrying fewer than ``n_backups`` backups — the
        slots a rejoining server offers itself to."""
        return [i for i, s in enumerate(self.shards)
                if len(s["backups"]) < int(n_backups)]

    def shards_primaried_by(self, endpoint):
        return [i for i, s in enumerate(self.shards)
                if s["primary"] == endpoint]

    # ---------------------------------------------------------------- misc
    def __eq__(self, other):
        return isinstance(other, ShardMap) and \
            self.to_dict() == other.to_dict()

    def __repr__(self):
        return (f"ShardMap(epoch={self.epoch}, n_shards={self.n_shards}, "
                f"servers={self.servers})")
