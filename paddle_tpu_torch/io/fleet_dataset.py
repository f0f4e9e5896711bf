"""Industrial dataset pipeline: InMemoryDataset / QueueDataset
(paddle_tpu/io/fleet_dataset.py).

Analog of the reference's C++ Dataset tier (reference
framework/data_set.h:157 InMemoryDataset + GlobalShuffle :205,
framework/data_feed.h:663 MultiSlotDataFeed, framework/channel.h) and its
Python face (fluid/dataset.py DatasetFactory). MultiSlot files parse on a
thread pool through ``_native.parse_multislot_file``, the port's copy of
the JAX package's C++ parser (``_native/src/multislot_parser.cc``, built
with g++ at first use; the pure-Python parser only where that cannot
build); samples live in the packed ragged form and batches materialize as
dense or padded numpy arrays shaped to the declared feed Variables.

Shuffles: ``local_shuffle`` permutes this process's samples from the
dataset's seed counter; ``global_shuffle`` draws the same permutation of
the sample-id space on every process (a shared seed) and takes this
rank's strided shard, with the rank and world size of
``distributed/env.py``. The same seed gives the same orders and batches
as the JAX package's.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset",
           "DatasetFactory"]


def _slot_type(var):
    dt = str(getattr(var, "dtype", "float32"))
    return "uint64" if ("int" in dt) else "float"


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._use_var = []
        self._filelist = []
        self._seed = 0

    # -- reference fluid/dataset.py configuration surface -------------------
    def init(self, batch_size=1, thread_num=1, use_var=None, **kwargs):
        self.set_batch_size(batch_size)
        self.set_thread_num(thread_num)
        if use_var is not None:
            self.set_use_var(use_var)
        return self

    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread_num(self, thread_num):
        self._thread_num = max(1, int(thread_num))

    def set_use_var(self, var_list):
        self._use_var = list(var_list)

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def get_filelist(self):
        return list(self._filelist)

    def _slot_types(self):
        if not self._use_var:
            raise ValueError("set_use_var() before loading: slot types come "
                             "from the feed variables' dtypes")
        return [_slot_type(v) for v in self._use_var]

    def _parse_files(self, files):
        """Parse files on a thread pool."""
        from concurrent.futures import ThreadPoolExecutor
        from .._native import parse_multislot_file
        types = self._slot_types()
        results = [None] * len(files)
        with ThreadPoolExecutor(max_workers=self._thread_num) as pool:
            futs = {pool.submit(parse_multislot_file, f, types): i
                    for i, f in enumerate(files)}
            for fut, i in futs.items():
                results[i] = fut.result()
        return results

    def _rows_to_feed(self, order, values, splits):
        """Materialize a batch: per slot, rows `order` padded/reshaped to
        the declared var shape (dense slots reshape; ragged slots pad or
        truncate to shape[1])."""
        feed = {}
        for s, var in enumerate(self._use_var):
            vals, spl = values[s], splits[s]
            want = list(getattr(var, "shape", ()))[1:]
            rows = [vals[spl[i]:spl[i + 1]] for i in order]
            dt = np.float32 if _slot_type(var) == "float" else np.int64
            if want and all(len(r) == int(np.prod(want)) for r in rows):
                arr = np.stack(rows).reshape([len(rows)] + want).astype(dt)
            else:  # ragged -> pad/truncate to the declared width
                width = want[0] if want else max(
                    (len(r) for r in rows), default=1)
                arr = np.zeros([len(rows), width], dt)
                for i, r in enumerate(rows):
                    n = min(len(r), width)
                    arr[i, :n] = r[:n]
            feed[var.name] = arr
        return feed


class InMemoryDataset(DatasetBase):
    """reference framework/data_set.h:157."""

    def __init__(self):
        super().__init__()
        self._values = None   # per slot: np values
        self._splits = None   # per slot: np row_splits
        self._rows = 0
        self._order = None
        self._pending_order = None   # restored before load_into_memory

    def load_into_memory(self):
        types_n = len(self._slot_types())
        per_file = self._parse_files(self._filelist)
        values = [[] for _ in range(types_n)]
        splits = [[np.zeros(1, np.int64)] for _ in range(types_n)]
        rows = 0
        for n_rows, slots in per_file:
            for s, (vals, spl) in enumerate(slots):
                base = splits[s][-1][-1]
                values[s].append(vals)
                splits[s].append(base + spl[1:])
            rows += n_rows
        self._values = [np.concatenate(v) if v else np.zeros(0)
                        for v in values]
        self._splits = [np.concatenate(s) for s in splits]
        self._rows = rows
        self._order = np.arange(rows)
        if self._pending_order is not None:
            order, self._pending_order = self._pending_order, None
            self._check_order(order)
            self._order = order

    def get_memory_data_size(self):
        return self._rows

    def release_memory(self):
        self._values = self._splits = self._order = None
        self._rows = 0

    def local_shuffle(self):
        rng = np.random.RandomState(self._seed)
        self._seed += 1
        self._order = rng.permutation(self._rows)

    def global_shuffle(self, fleet=None, thread_num=None):
        """Same permutation on every process (shared seed), strided shard
        per rank — see module docstring for the design delta vs the
        reference's PS-exchange (data_set.h:205)."""
        from ..distributed.env import get_rank, get_world_size
        rng = np.random.RandomState(7919 + self._seed)
        self._seed += 1
        perm = rng.permutation(self._rows)
        nproc = get_world_size()
        if nproc > 1:
            perm = perm[get_rank()::nproc]
        self._order = perm

    def batches(self, drop_last=True, start_batch=0):
        """`start_batch` skips the first N batches at the index level (no
        parse/pad work) — the exact-resume entry point
        Executor.train_from_dataset threads its start_batch through."""
        if self._values is None:
            raise RuntimeError("call load_into_memory() first")
        bs = self._batch_size
        n = len(self._order)
        stop = (n // bs) * bs if drop_last else n
        for lo in range(int(start_batch) * bs, stop, bs):
            order = self._order[lo:lo + bs]
            yield self._rows_to_feed(order, self._values, self._splits)

    # -- exact resume --------------------------------------------------------
    def state_dict(self):
        """Shuffle position for the checkpoint's `data` section: the
        seed counter and, when a shuffle has been drawn, the current
        sample order itself (exact — no re-derivation assumptions)."""
        sd = {"seed": int(self._seed)}
        if self._order is not None:
            sd["order"] = np.asarray(self._order, np.int64)
        return sd

    def _check_order(self, order):
        if len(order) != self._rows:
            raise ValueError(
                f"dataset state has {len(order)} samples but "
                f"{self._rows} are loaded — resume state belongs to "
                "a different filelist")

    def load_state_dict(self, sd):
        self._seed = int(sd.get("seed", 0))
        order = sd.get("order")
        if order is None:
            return
        order = np.asarray(order, np.int64)
        if not self._rows:
            # restored before load_into_memory: DEFER the order (applied
            # when rows load) rather than silently dropping it — a
            # later shuffle from seed+1 would walk a different
            # permutation than the killed run
            self._pending_order = order
            return
        self._check_order(order)
        self._order = order


class QueueDataset(DatasetBase):
    """Streaming variant (reference QueueDataset): files parse in a
    background thread into a bounded queue — the framework/channel.h
    analog — while training consumes batches."""

    QUEUE_CAPACITY = 8

    def batches(self, drop_last=True):
        q = queue.Queue(maxsize=self.QUEUE_CAPACITY)
        SENTINEL = object()

        def producer():
            try:
                carry_vals, carry_spl, carry_rows = None, None, 0
                for f in self._filelist:
                    from .._native import parse_multislot_file
                    n_rows, slots = parse_multislot_file(
                        f, self._slot_types())
                    values = [v for v, _ in slots]
                    splits = [s for _, s in slots]
                    for lo in range(0, (n_rows // self._batch_size)
                                    * self._batch_size, self._batch_size):
                        order = np.arange(lo, lo + self._batch_size)
                        q.put(self._rows_to_feed(order, values, splits))
            finally:
                q.put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            yield item


class DatasetFactory:
    """reference fluid/dataset.py DatasetFactory."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")
