"""HeterPS — tiered device-resident embedding cache over the host PS
(paddle_tpu/distributed/ps/heter.py).

Reference tier: framework/fleet/heter_ps/hashtable.h + heter_comm.h (a
GPU-resident concurrent hashtable caching hot embedding rows, backed by
the CPU parameter server). Here the table is a pair of torch tensors on
the card (open-addressing keys [cap] int64 + values [cap, dim]), with
LOOKUP as a vectorized fixed-probe gather (a handful of torch ops, no
host sync) and INSERT as a serial placement over a host mirror of the
keys followed by one scatter each into keys and values (once per batch
on the miss set, off the hot path). The JAX package has no kernel here
either: XLA lowers both to gathers and scatters.

The cache is TIERED (HeterPS lineage — tables larger than device memory):

  device tier   hot-id LRU, bounded by PADDLE_PS_HETER_CACHE_ROWS; rows
                past the bound evict oldest-first (`ps.heter.evictions`)
  host tier     evicted rows park in host RAM, bounded by
                PADDLE_PS_HETER_HOST_ROWS; a host hit re-promotes to the
                device tier without a PS round trip (`ps.heter.host_hits`)
  PS tier       authoritative sharded storage; misses in both tiers pull
                through the client's batched deduped cross-shard fan-out

Semantics: read-through cache with push-through writes —
  rows = cache.pull(ids)        # device hits + host hits + PS misses
  ...                           # grads computed on device
  cache.push_grad(ids, grads)   # goes to the PS (server accessor owns
                                # the update rule), cached copies refresh
so the server stays authoritative (same division of labor as the
reference: hashtable.h caches, the DownpourPsClient owns optimizer state).

Coherence across MEMBERSHIP CHANGES: the cache registers a shard-map
listener on its PSClient (`add_map_listener`), so every adoption of a
newer map — stale-epoch redirect, failover promotion, eviction gossip —
invalidates BOTH tiers (`ps.heter.invalidations`): a row cached before a
promotion can never be served after it. A pull that was already in
flight when the epoch moved re-checks the epoch before populating the
tiers and skips the insert, closing the race where pre-change rows
sneak into a post-change cache.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from ...core import monitor as _monitor
from ...core.flags import flag as _flag
from .client import _host

__all__ = ["DeviceHashTable", "HeterPSCache"]

_EMPTY = np.int64(-1)
# splitmix64's multipliers as signed int64 (0xbf58476d1ce4e5b9,
# 0x94d049bb133111eb)
_M1 = -4658895280553007687
_M2 = -7723592293110705685


def _mix(h):
    """splitmix64 finalizer over int64 with wrap-around — good avalanche
    for sequential ids. ``h`` is a torch int64 tensor (arithmetic ``>>``,
    int64 multiply that wraps) or an int64 numpy array (the same bits)."""
    h = (h ^ (h >> 30)) * _M1
    h = (h ^ (h >> 27)) * _M2
    return h ^ (h >> 31)


def _np_slots(ids, capacity, max_probes):
    """[n, max_probes] candidate slots per id, on the host. numpy's ``%``
    is floor-mod, as jnp's and ``torch.remainder`` are."""
    with np.errstate(over="ignore"):
        h = _mix(ids.astype(np.int64)) % capacity
    probe = np.arange(max_probes, dtype=np.int64)
    return (h[:, None] + probe[None, :]) % capacity


def place(keys, ids, capacity, max_probes):
    """The serial placement of a batch insert, on a host copy of the
    keys: ids are placed in order; a slot already holding the id is
    preferred over an earlier empty one; an id is placed only if its
    probe window has a usable slot. Updates ``keys`` in place and returns
    (slot per id, placed mask)."""
    slots = _np_slots(ids, capacity, max_probes)
    n = ids.shape[0]
    out = np.zeros(n, np.int64)
    placed = np.zeros(n, bool)
    for i in range(n):
        cand = slots[i]
        kcand = keys[cand]
        ident = ids[i]
        match = kcand == ident
        if match.any():
            j = int(np.argmax(match))
        else:
            usable = kcand == _EMPTY
            if not usable.any():
                continue
            j = int(np.argmax(usable))
        slot = cand[j]
        keys[slot] = ident
        out[i] = slot
        placed[i] = True
    return out, placed


def last_per_slot(slots):
    """Indices of the last occurrence of each distinct slot, in order of
    those occurrences: a scatter with repeated indices resolves in no
    fixed order on the card, so only the last write to a slot (the one
    the serial insert keeps) may go into it."""
    rev = slots[::-1]
    _, first_rev = np.unique(rev, return_index=True)
    return np.sort(len(slots) - 1 - first_rev)


class DeviceHashTable:
    """Fixed-capacity open-addressing (linear probe) id -> row table on
    the card (paddle_tpu/distributed/ps/heter.py:62): ``keys`` [cap]
    int64 and ``values`` [cap, dim] are device tensors, with a host
    mirror of ``keys`` (capacity x 8 bytes) that the insert and remove
    placements read. Supports vectorized remove() so an LRU layer above
    can evict; lookups scan the FULL probe window (no early stop at an
    empty slot), which is what makes removal safe under linear probing
    without tombstones.

    ``lookup`` is the JAX package's vectorized fixed-probe gather in
    torch, on the device. ``insert`` keeps its serial placement (a
    ``lax.fori_loop`` there): ``place`` walks the ids over the host
    mirror, then the device keys and values take one scatter each, the
    values deduplicated to the last write of each slot first. After the
    same inserts and removes the keys are bitwise the JAX package's.
    ``device``: None is the current device (the card unless
    ``set_device('cpu')``)."""

    def __init__(self, capacity, dim, max_probes=16, dtype="float32",
                 device=None):
        import torch
        from ...device import resolve_device
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.max_probes = int(max_probes)
        self.device = resolve_device(device)
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        self._keys_host = np.full((self.capacity,), _EMPTY, np.int64)
        self.keys = torch.full((self.capacity,), int(_EMPTY),
                               dtype=torch.int64, device=self.device)
        self.values = torch.zeros((self.capacity, self.dim), dtype=dt,
                                  device=self.device)
        self._count = 0

    def _ids(self, ids):
        import torch
        if isinstance(ids, torch.Tensor):
            return ids.detach().to(self.device, torch.int64).reshape(-1)
        return torch.as_tensor(np.asarray(ids, np.int64).reshape(-1),
                               device=self.device)

    def _slots(self, ids):
        """[n, max_probes] candidate slots per query id (device)."""
        import torch
        h = torch.remainder(_mix(ids), self.capacity)
        probe = torch.arange(self.max_probes, dtype=torch.int64,
                             device=ids.device)
        return torch.remainder(h[:, None] + probe[None, :], self.capacity)

    def lookup(self, ids):
        """ids [n] -> (rows [n, dim], found [n] bool), device tensors; no
        host sync. Missing ids read zeros."""
        ids = self._ids(ids)
        slots = self._slots(ids)                       # [n, P]
        hit = self.keys[slots] == ids[:, None]
        found = hit.any(dim=1)
        # first hit slot (or slot 0 — masked out below)
        idx = hit.to(dtype=slots.dtype).argmax(dim=1)
        sel = slots.gather(1, idx[:, None])[:, 0]
        rows = self.values[sel] * found[:, None].to(self.values.dtype)
        return rows, found

    def insert(self, ids, rows, best_effort=False):
        """Batch insert (linear probing; existing keys are overwritten).
        A row whose probe window is exhausted either raises (default —
        size the capacity >= ~2x the working set) or, with
        ``best_effort=True``, is skipped: the caller gets the per-row
        placed mask (numpy) back and decides where unplaced rows live
        (the tiered cache demotes them to host RAM — a CACHE must never
        hard-fail because 16 consecutive slots happened to cluster)."""
        import torch
        ids_np = np.asarray(_host(ids), np.int64).reshape(-1)
        keys = self._keys_host.copy()
        slots, placed = place(keys, ids_np, self.capacity,
                              self.max_probes)
        if not best_effort and not placed.all():
            raise RuntimeError(
                f"DeviceHashTable over capacity ({self.capacity} slots, "
                f"{self.max_probes} probes) — grow it or evict")
        rows_t = rows if isinstance(rows, torch.Tensor) \
            else torch.as_tensor(np.asarray(rows))
        rows_t = rows_t.detach().reshape(ids_np.shape[0], self.dim)
        keep = np.nonzero(placed)[0]
        if keep.size:
            keep = keep[last_per_slot(slots[keep])]
            dst = torch.as_tensor(slots[keep], device=self.device)
            src = torch.as_tensor(keep, device=rows_t.device)
            self.values.index_copy_(
                0, dst, rows_t.index_select(0, src).to(
                    self.device, self.values.dtype))
            self.keys.index_copy_(
                0, dst, torch.as_tensor(ids_np[keep], device=self.device))
        self._keys_host = keys
        self._count = int(np.count_nonzero(keys != _EMPTY))
        return placed if best_effort else self

    def remove(self, ids):
        """Vectorized batch remove: present ids' slots flip back to
        EMPTY (values left in place — unreachable once the key is gone,
        because lookup masks by `found`). Absent ids are ignored."""
        import torch
        ids_np = np.asarray(_host(ids), np.int64).reshape(-1)
        if ids_np.shape[0] == 0:
            return self
        slots = _np_slots(ids_np, self.capacity, self.max_probes)
        hit = self._keys_host[slots] == ids_np[:, None]
        found = hit.any(axis=1)
        # the first hit slot of each id (slot 0 of an absent one)
        sel = np.take_along_axis(slots, np.argmax(hit, axis=1)[:, None],
                                 axis=1)[:, 0]
        # scatter ONLY the found rows' slots: an absent id's bogus slot-0
        # candidate may alias a present id's slot, and a duplicate-index
        # scatter writing {EMPTY, old-key} to one slot resolves in
        # unspecified order — the removed key could resurrect
        if found.any():
            gone = np.unique(sel[found])
            self._keys_host[gone] = _EMPTY
            self.keys.index_fill_(
                0, torch.as_tensor(gone, device=self.device), int(_EMPTY))
            # incremental count (unique slots: robust to duplicate ids)
            self._count -= len(gone)
        return self

    def __len__(self):
        return self._count


class HeterPSCache:
    """Tiered read-through device cache over a PSClient sparse table.

    `capacity` bounds the DEVICE tier's resident rows (None -> the
    PADDLE_PS_HETER_CACHE_ROWS flag); `host_rows` bounds the host tier
    (None -> PADDLE_PS_HETER_HOST_ROWS, 0 disables it). All state is
    serialized under one reentrant lock, so a background prefetch pull
    and the trainer's push cannot interleave a stale row into a tier.
    """

    def __init__(self, client, table, dim, capacity=None, max_probes=16,
                 host_rows=None, device=None):
        self.client = client
        self.table = table
        self.dim = int(dim)
        self._bound = int(_flag("PADDLE_PS_HETER_CACHE_ROWS")
                          if capacity is None else capacity)
        self._host_bound = int(_flag("PADDLE_PS_HETER_HOST_ROWS")
                               if host_rows is None else host_rows)
        self._max_probes = int(max_probes)
        # device slots ~2x the row bound: linear probing needs headroom
        self.dev = DeviceHashTable(max(2 * self._bound, 64), dim,
                                   max_probes, device=device)
        self._lru: OrderedDict[int, bool] = OrderedDict()   # device ids
        self._host: OrderedDict[int, np.ndarray] = OrderedDict()
        self._lock = threading.RLock()
        self._invalidate_pending = False
        self._valid_epoch = self._epoch()
        self.hits = 0
        self.misses = 0
        # membership-change coherence: any shard-map adoption on the
        # client (promotion, eviction, stale redirect) nukes both tiers
        if hasattr(client, "add_map_listener"):
            client.add_map_listener(self._on_map_change)

    # ------------------------------------------------------------- helpers
    def _epoch(self):
        m = getattr(self.client, "shard_map", None)
        return getattr(m, "epoch", 0)

    def _on_map_change(self, _new_map):
        # DEFERRED, not inline: the adoption may fire on a fan-out
        # worker that this cache's in-flight pull is itself waiting on —
        # taking the cache lock here would deadlock. Serving only ever
        # happens through pull(), and pull() applies the pending
        # invalidation before reading a single row, so no pre-change hit
        # can be served after the membership change.
        self._invalidate_pending = True

    def _revalidate(self):
        """Caller holds self._lock. Two triggers, one clear: the
        listener's pending flag, AND a synchronous epoch comparison —
        the listener fires OUTSIDE the client's map lock, so another
        thread's adoption can complete (map swapped) a beat before the
        flag lands; reading the epoch here cannot lag the swap, so an
        adoption that happened-before this call always invalidates
        before a single row is read."""
        e = self._epoch()
        if self._invalidate_pending or e != self._valid_epoch:
            self._invalidate_pending = False
            self._valid_epoch = e
            self._clear_tiers()
            _monitor.stat_add("ps.heter.invalidations")

    def __len__(self):
        with self._lock:
            return len(self._lru)

    @property
    def host_len(self):
        with self._lock:
            return len(self._host)

    def _host_put(self, i, row):
        """Caller holds self._lock; bounded host-tier upsert."""
        if self._host_bound <= 0:
            return
        self._host[int(i)] = np.asarray(row, np.float32).copy()
        self._host.move_to_end(int(i))
        while len(self._host) > self._host_bound:
            self._host.popitem(last=False)

    def _insert_device(self, ids, rows):
        """Caller holds self._lock. Best-effort device insert: rows
        whose probe window is exhausted demote to the host tier instead
        of failing the pull (`ps.heter.probe_drops`). Returns the ids
        that are actually device-resident."""
        placed = self.dev.insert(ids, rows, best_effort=True)
        if not placed.all():
            _monitor.stat_add("ps.heter.probe_drops",
                              int((~placed).sum()))
            if not isinstance(rows, np.ndarray):
                rows = rows.float().cpu().numpy()
            for k in np.nonzero(~placed)[0]:
                self._host_put(ids[k], rows[k])
        return ids[placed]

    def _touch(self, ids):
        """Mark device-resident ids as most-recently-used and evict past
        the bound (device -> host tier demotion)."""
        for i in ids:
            i = int(i)
            self._lru[i] = True
            self._lru.move_to_end(i)
        n_evict = len(self._lru) - self._bound
        if n_evict <= 0:
            return
        victims = [self._lru.popitem(last=False)[0] for _ in range(n_evict)]
        varr = np.asarray(victims, np.int64)
        if self._host_bound > 0:
            rows, found = self.dev.lookup(varr)
            rows = rows.float().cpu().numpy()
            found = found.cpu().numpy()
            for k, i in enumerate(victims):
                if found[k]:
                    self._host_put(i, rows[k])
        self.dev.remove(varr)
        _monitor.stat_add("ps.heter.evictions", n_evict)

    # ---------------------------------------------------------------- pull
    def pull(self, ids):
        """ids any-shape ints -> rows [n_unique, dim] (device), index
        mapping like SparseEmbedding.pull. Misses fetch host tier first,
        then the sharded PS (one batched deduped fan-out), and populate
        the device table. The rows are a tensor on the cache's device;
        the misses reach it in one host-to-device copy."""
        import torch
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        uniq, inv = np.unique(ids_np, return_inverse=True)
        with self._lock:
            self._revalidate()
            epoch0 = self._epoch()
            rows, found = self.dev.lookup(uniq)
            found_np = found.cpu().numpy()
            miss = uniq[~found_np]
            n_hits = int(found_np.sum())
            self.hits += n_hits
            # cache efficiency next to the transport's ps.rpc.* flakiness
            # counters: a miss storm after a PS reconnect shows up here
            _monitor.stat_add("ps.heter.hits", n_hits)
            if len(miss):
                fetched = np.empty((len(miss), self.dim), np.float32)
                host_mask = np.zeros(len(miss), bool)
                for k, i in enumerate(miss):
                    row = self._host.pop(int(i), None)
                    if row is not None:
                        fetched[k] = row
                        host_mask[k] = True
                n_host = int(host_mask.sum())
                n_ps = len(miss) - n_host
                self.misses += n_ps
                _monitor.stat_add("ps.heter.host_hits", n_host)
                _monitor.stat_add("ps.heter.misses", n_ps)
                if n_ps:
                    fetched[~host_mask] = np.asarray(
                        self.client.pull_sparse(self.table,
                                                miss[~host_mask]),
                        np.float32)
                fetched_t = torch.as_tensor(fetched).to(
                    self.dev.device, self.dev.values.dtype)
                if self._epoch() == epoch0:
                    resident = self._insert_device(miss, fetched_t)
                    self._touch(np.concatenate([uniq[found_np],
                                                resident]))
                # else: the shard map moved UNDER this pull (a failover
                # resolved it) — serve the rows, but don't let a
                # pre-change fetch populate the post-change cache
                rows[torch.as_tensor(~found_np, device=rows.device)] = \
                    fetched_t
            else:
                self._touch(uniq)
        return rows, inv.reshape(np.shape(ids))

    # ---------------------------------------------------------------- push
    def push_grad(self, ids, grads):
        """Push grads to the PS (authoritative update), then refresh the
        cached copies with the server's post-update rows."""
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        if ids_np.size == 0:
            return              # no-op, same contract as the client layer
        # duplicate-id merging (MergeAdd) is the CLIENT's job — one
        # implementation of the bitwise-sensitive merge, not three; the
        # cache only needs the unique set for its refresh pull and tiers
        uniq = np.unique(ids_np)
        with self._lock:
            self._revalidate()
            epoch0 = self._epoch()
            self.client.push_sparse_grad(self.table, ids_np, grads)
            fresh = np.asarray(self.client.pull_sparse(self.table, uniq),
                               np.float32)
            # pushed ids leave the host tier: the device copy is now the
            # freshest cached one, and a later demotion re-parks it
            for i in uniq:
                self._host.pop(int(i), None)
            if self._epoch() == epoch0:
                self._touch(self._insert_device(uniq, fresh))

    # --------------------------------------------------------------- admin
    def _clear_tiers(self):
        """Caller holds self._lock."""
        self.dev = DeviceHashTable(self.dev.capacity, self.dev.dim,
                                   self.dev.max_probes,
                                   dtype=self.dev.values.dtype,
                                   device=self.dev.device)
        self._lru.clear()
        self._host.clear()

    def invalidate(self):
        """Drop BOTH tiers (membership change / external writer). Every
        next pull re-reads through the sharded PS."""
        with self._lock:
            self._invalidate_pending = False
            self._valid_epoch = self._epoch()
            self._clear_tiers()
        _monitor.stat_add("ps.heter.invalidations")
        return self
