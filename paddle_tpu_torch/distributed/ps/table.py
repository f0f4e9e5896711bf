"""Parameter-server tables (paddle_tpu/distributed/ps/table.py, whole;
numpy, the port's own copy: the same grads give bitwise the same state as
the JAX package's tables).

The reference PS table layer (N21:
paddle/fluid/distributed/table/ — CommonDenseTable common_dense_table.cc,
CommonSparseTable common_sparse_table.cc, SparseGeoTable
sparse_geo_table.cc, BarrierTable barrier_table.cc; accessor update rules
from table/depends/sparse.h + the optimizer ops they mirror).

Design deltas (SURVEY.md §2.1 N20-N22, hard part 5):
- Tables are host-resident numpy state. The card never sees the full
  (unbounded) sparse vocab: workers pull just the rows a batch touches,
  the step computes row gradients on the card, and workers push those
  rows back. That is the "host-KV + gather" sharded-embedding design —
  the device works on dense [n_ids, dim] blocks, the hash map stays
  host-side.
- Update rules run server-side on push (reference "accessor" semantics),
  so async workers never hold optimizer slots for sparse params.
- Rows are created lazily on first touch (reference large_scale_kv.h
  auto-grown entries) with per-table initializers.
"""
from __future__ import annotations

import threading
import zlib

import numpy as np

__all__ = ["DenseTable", "SparseTable", "GeoSparseTable", "BarrierTable",
           "make_table"]


# ---------------------------------------------------------------- accessors

def _sgd_init(shape, dtype):
    return {}


def _sgd_apply(param, grad, slots, lr):
    param -= lr * grad
    return param


def _adagrad_init(shape, dtype):
    return {"moment": np.zeros(shape, dtype)}


def _adagrad_apply(param, grad, slots, lr, eps=1e-6):
    m = slots["moment"]
    m += grad * grad
    param -= lr * grad / (np.sqrt(m) + eps)
    return param


def _adam_init(shape, dtype):
    return {"m": np.zeros(shape, dtype), "v": np.zeros(shape, dtype),
            "t": np.zeros(shape[:-1] + (1,), np.int64) if len(shape) > 1
            else np.zeros((1,), np.int64)}


def _adam_apply(param, grad, slots, lr, beta1=0.9, beta2=0.999, eps=1e-8):
    slots["t"] += 1
    t = slots["t"]
    m, v = slots["m"], slots["v"]
    m *= beta1
    m += (1 - beta1) * grad
    v *= beta2
    v += (1 - beta2) * grad * grad
    mhat = m / (1 - beta1 ** t)
    vhat = v / (1 - beta2 ** t)
    param -= lr * mhat / (np.sqrt(vhat) + eps)
    return param


_ACCESSORS = {
    "sgd": (_sgd_init, _sgd_apply),
    "adagrad": (_adagrad_init, _adagrad_apply),
    "adam": (_adam_init, _adam_apply),
}


def _splitmix64(x):
    """Vectorized splitmix64 over uint64 arrays (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _initializer(kind, dim, seed):
    """Per-ID deterministic row initializer: rows(ids) -> [len(ids), dim].

    A row's initial value is a pure function of (seed, id, column) — a
    counter-based hash stream, not a shared sequential RNG. That makes
    materialization ORDER-INDEPENDENT, which the replicated storage tier
    requires: a promoted backup (or a rejoined server) materializes a
    never-pushed row on first pull, and it must get bit-identical values
    to the row the dead primary would have served, no matter how many
    rows either side created in between."""
    if kind == "zeros":
        return lambda ids: np.zeros((len(ids), dim), np.float32)
    if kind not in ("uniform", "normal"):
        raise ValueError(f"unknown initializer {kind!r}")
    base = np.uint64(seed) * np.uint64(0x2545F4914F6CDD1D) \
        ^ np.uint64(zlib.crc32(kind.encode()))

    def rows(ids):
        ids_u = np.asarray(ids, np.int64).reshape(-1, 1).view(np.uint64)
        cols = np.arange(dim, dtype=np.uint64).reshape(1, -1)
        h = _splitmix64(ids_u * np.uint64(0x100000001B3) ^ cols ^ base)
        # top 53 bits -> uniform [0, 1)
        u = (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
        if kind == "uniform":
            scale = 1.0 / np.sqrt(dim)
            return ((u * 2.0 - 1.0) * scale).astype(np.float32)
        # normal: Box-Muller from two independent hash streams
        h2 = _splitmix64(h ^ np.uint64(0xD6E8FEB86659FD93))
        u2 = (h2 >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
        u = np.maximum(u, 2.0 ** -53)          # log(0) guard
        z = np.sqrt(-2.0 * np.log(u)) * np.cos(2.0 * np.pi * u2)
        return (z * 0.01).astype(np.float32)

    return rows


# ------------------------------------------------------------------ tables

class DenseTable:
    """Whole-parameter block with a server-side update rule (reference
    common_dense_table.cc: values_ + per-rule slots, pull_dense returning
    the block, push_dense applying sgd/adam/"sum")."""

    def __init__(self, shape, optimizer="sgd", lr=0.01, init="zeros",
                 seed=0):
        shape = tuple(int(s) for s in shape)
        if init == "zeros":
            self.param = np.zeros(shape, np.float32)
        else:
            rng = np.random.RandomState(seed)
            self.param = (rng.randn(*shape) *
                          (0.01 if init == "normal"
                           else 1.0 / np.sqrt(shape[-1]))).astype(np.float32)
        slot_init, self._apply = _ACCESSORS[optimizer]
        self._slots = slot_init(shape, np.float32)
        self.lr = float(lr)
        self._lock = threading.Lock()
        # count of APPLIED mutations (not replayed retries) — the
        # observable behind the exactly-once chaos assertions
        self.applied = 0

    def pull(self):
        with self._lock:
            return self.param.copy()

    def push_grad(self, grad):
        grad = np.asarray(grad, np.float32).reshape(self.param.shape)
        with self._lock:
            self.param = self._apply(self.param, grad, self._slots, self.lr)
            self.applied += 1

    def set(self, value):
        with self._lock:
            # np.array, not asarray: RPC payloads arrive as READ-ONLY
            # views over pickle-5 buffers, and the accessors update
            # self.param in place
            self.param = np.array(value, np.float32).reshape(
                self.param.shape)
            self.applied += 1

    def state(self):
        with self._lock:
            return {"param": self.param.copy(),
                    "slots": {k: v.copy() for k, v in self._slots.items()},
                    "lr": self.lr}

    def load_state(self, st):
        with self._lock:
            # np.array copies: state arriving over RPC (load_table_state)
            # is a read-only pickle-5 buffer view, and accessors mutate
            # param/slots in place
            self.param = np.array(st["param"], np.float32)
            self._slots = {k: np.array(v) for k, v in st["slots"].items()}
            self.lr = float(st.get("lr", self.lr))


class SparseTable:
    """Auto-growing id -> row KV store (reference common_sparse_table.cc +
    operators/distributed/large_scale_kv.h: rows materialize on first
    access; pull_sparse gathers, push_sparse applies the accessor rule to
    just the touched rows). ids are arbitrary int64 — no dense vocab bound.

    Storage is array-backed (one [n, dim] block + an id->index map +
    per-slot blocks), so pull is one fancy-index gather and push applies
    the accessor rule to the whole touched block at once — the vectorized
    form of the reference's per-shard value blocks (common_sparse_table.cc
    shard_values_), with geometric capacity growth. Measured ~8x
    end-to-end over the per-row-dict design (tools/ps_load_test.py:
    ~0.83M rows/sec aggregate on 4 local workers).
    """

    def __init__(self, dim, optimizer="adagrad", lr=0.05, init="uniform",
                 seed=0):
        self.dim = int(dim)
        self._index: dict[int, int] = {}
        slot_init, self._apply = _ACCESSORS[optimizer]
        self._slot_init = lambda n: slot_init((n, self.dim), np.float32)
        self._data = np.zeros((0, self.dim), np.float32)
        self._slots = self._slot_init(0)
        self._init_rows = _initializer(init, self.dim, seed)
        self.lr = float(lr)
        self._lock = threading.Lock()
        self.applied = 0  # applied mutations; see DenseTable.applied

    def __len__(self):
        return len(self._index)

    def _ensure(self, ids):
        # dedupe while preserving first-seen order: a batch like
        # [5, 9, 5] must materialize id 5 ONCE, or the duplicate would
        # claim two rows and corrupt _index for every later id
        missing = [i for i in dict.fromkeys(ids) if i not in self._index]
        if not missing:
            return
        base = len(self._index)
        need = base + len(missing)
        cap = len(self._data)
        if need > cap:  # geometric growth: amortized O(new rows)
            new_cap = max(need, cap * 2, 1024)

            def grow(arr):
                out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
                out[:len(arr)] = arr
                return out

            self._data = grow(self._data)
            self._slots = {k: grow(v) for k, v in self._slots.items()}
        self._data[base:need] = self._init_rows(missing)
        fresh = self._slot_init(len(missing))
        for k in self._slots:
            self._slots[k][base:need] = fresh[k]
        for k, i in enumerate(missing):
            self._index[i] = base + k

    def _idx(self, ids):
        ix = self._index
        return np.fromiter((ix[i] for i in ids), np.int64, count=len(ids))

    def pull(self, ids):
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        with self._lock:
            self._ensure(ids)
            if not ids:
                return np.zeros((0, self.dim), np.float32)
            return self._data[self._idx(ids)].copy()

    def push_grad(self, ids, grads):
        """Duplicate ids in one push are accumulated first (reference
        MergeAdd over SelectedRows before the rule applies)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(merged, inv, grads)
        keys = [int(i) for i in uniq]
        with self._lock:
            self._ensure(keys)
            idx = self._idx(keys)
            block = self._data[idx]
            slot_block = {k: v[idx] for k, v in self._slots.items()}
            block = self._apply(block, merged, slot_block, self.lr)
            self._data[idx] = block
            for k, v in slot_block.items():
                self._slots[k][idx] = v
            self.applied += 1

    def state(self):
        with self._lock:
            n = len(self._index)
            ids = np.zeros(n, np.int64)
            for i, pos in self._index.items():
                ids[pos] = i
            return {"ids": ids, "values": self._data[:n].copy(),
                    "lr": self.lr,
                    "slots": {int(i): {k: self._slots[k][pos].copy()
                                       for k in self._slots}
                              for i, pos in self._index.items()}}

    def load_state(self, st, merge=False):
        """merge=False resets the table to exactly `st`; merge=True
        UPSERTS `st`'s rows over the existing ones (rows absent from
        `st` keep their values) — the replica catch-up path merges one
        shard's rows at a time without clobbering rows it already holds
        for other shards."""
        with self._lock:
            ids = [int(i) for i in st["ids"]]
            if merge:
                self._ensure(ids)
                if ids:
                    idx = self._idx(ids)
                    self._data[idx] = np.array(
                        st["values"], np.float32).reshape(len(ids),
                                                          self.dim)
            else:
                self._index = {i: pos for pos, i in enumerate(ids)}
                # np.array copies — see DenseTable.load_state
                self._data = np.array(st["values"], np.float32).reshape(
                    len(ids), self.dim)
                self._slots = self._slot_init(len(ids))
            for i, s in (st.get("slots", {}) or {}).items():
                pos = self._index.get(int(i))
                if pos is None:
                    continue
                for k, v in s.items():
                    self._slots[k][pos] = np.asarray(v)
            self.lr = float(st.get("lr", self.lr))


class GeoSparseTable(SparseTable):
    """Geo-SGD variant (reference sparse_geo_table.cc + communicator.cc
    GeoCommunicator): workers train LOCAL embedding copies and
    periodically push the delta vs their last sync; the server folds
    deltas in and hands back fresh rows. push is plain addition — the
    worker already applied its own optimizer."""

    def __init__(self, dim, lr=1.0, init="uniform", seed=0):
        super().__init__(dim, optimizer="sgd", lr=lr, init=init, seed=seed)

    def push_delta(self, ids, deltas):
        ids = np.asarray(ids, np.int64).reshape(-1)
        deltas = np.asarray(deltas, np.float32).reshape(len(ids), self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(merged, inv, deltas)
        keys = [int(i) for i in uniq]
        with self._lock:
            self._ensure(keys)
            self._data[self._idx(keys)] += merged
            self.applied += 1


class BarrierTable:
    """Worker-count barrier (reference barrier_table.cc: trigger when all
    trainers arrive)."""

    def __init__(self, trainer_num):
        self.trainer_num = int(trainer_num)
        self._cond = threading.Condition()
        self._arrived = set()
        self._generation = 0

    def wait(self, trainer_id, timeout=120.0):
        with self._cond:
            gen = self._generation
            self._arrived.add(int(trainer_id))
            if len(self._arrived) >= self.trainer_num:
                self._arrived.clear()
                self._generation += 1
                self._cond.notify_all()
                return True
            ok = self._cond.wait_for(lambda: self._generation > gen,
                                     timeout=timeout)
            if not ok:
                raise TimeoutError(
                    f"barrier: {len(self._arrived)}/{self.trainer_num} "
                    f"trainers after {timeout}s")
            return True


def make_table(spec: dict):
    """Build a table from a config dict (reference ps.proto TableParameter:
    table type + accessor + common params)."""
    kind = spec.get("type", "sparse")
    if kind == "dense":
        return DenseTable(spec["shape"], spec.get("optimizer", "sgd"),
                          spec.get("lr", 0.01), spec.get("init", "zeros"),
                          spec.get("seed", 0))
    if kind == "sparse":
        return SparseTable(spec["dim"], spec.get("optimizer", "adagrad"),
                           spec.get("lr", 0.05), spec.get("init", "uniform"),
                           spec.get("seed", 0))
    if kind == "geo_sparse":
        return GeoSparseTable(spec["dim"], spec.get("lr", 1.0),
                              spec.get("init", "uniform"),
                              spec.get("seed", 0))
    if kind == "barrier":
        return BarrierTable(spec.get("trainer_num", 1))
    raise ValueError(f"unknown table type {kind!r}")
