"""DataLoader with background prefetch (paddle_tpu/io/dataloader.py).

Three ways to make batches, as in the JAX package:

- ``num_workers=0``: in the calling process;
- ``num_workers > 0`` with ``use_shared_memory=True`` (the default): forked
  worker processes take index lists from a task queue and send collated
  batches back, put back in sampler order by the parent;
- ``num_workers > 0`` with ``use_shared_memory=False``: a thread pool.

A double-buffer thread keeps batches ahead of the consumer so that host
collation overlaps the device step.

Workers build numpy only: ``default_collate_fn`` stacks samples into
numpy arrays, and the parent turns each array of a batch into a CPU
torch tensor as it hands the batch out. A forked worker inherits a parent
that may have initialised CUDA already; it must never touch the card,
and it runs its CPU work on one intra-op thread.

``state_dict`` / ``load_state_dict`` / ``roll_resumed_epoch`` keep the
epoch, the next-batch cursor and the sampler's RNG state, so a resume
lands on the exact next batch.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch

from ..core import trace as _trace
from ..framework.io import to_numpy
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


class _WorkerFailure:
    """Pickled across the result queue to re-raise in the parent."""

    def __init__(self, exc):
        self.type_name = type(exc).__name__
        self.message = str(exc)
        import traceback
        self.tb = traceback.format_exc()


def _worker_loop(dataset, collate_fn, index_q, result_q, init_fn, wid):
    torch.set_num_threads(1)
    if init_fn is not None:
        init_fn(wid)
    while True:
        task = index_q.get()
        if task is None:
            return
        bid, indices = task
        try:
            batch = collate_fn([dataset[i] for i in indices])
            result_q.put((bid, batch))
        except BaseException as e:  # noqa: BLE001 — must reach the parent
            result_q.put((bid, _WorkerFailure(e)))


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return np.stack([to_numpy(s) for s in batch])
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    return batch


def _to_torch(batch):
    """``batch`` with every numeric numpy array as a CPU torch tensor."""
    if isinstance(batch, np.ndarray) and batch.dtype.kind in "biuf":
        return torch.from_numpy(batch)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_torch(b) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_torch(v) for k, v in batch.items()}
    return batch


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 shuffle_seed=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        # exact-resume position: epoch count, next-batch cursor, pending
        # load_state_dict payload (docs/fault_tolerance.md "Trainer
        # recovery")
        self._epoch = 0
        self._pos_batch = 0
        self._resume = None
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif shuffle and shuffle_seed is not None:
            # a PRIVATE seeded shuffle stream: every epoch's permutation
            # is derivable from the checkpointed rng state alone, so a
            # restarted trainer replays the exact batch schedule
            from .sampler import RandomSampler
            self.batch_sampler = BatchSampler(
                sampler=RandomSampler(dataset, generator=shuffle_seed),
                batch_size=batch_size, drop_last=drop_last)
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    # -- exact mid-epoch resume ---------------------------------------------
    def state_dict(self):
        """Data-pipeline position for the checkpoint's `data` section:
        epoch, next-batch cursor, and the sampler's shuffle-rng state.
        None for IterableDataset loaders (no index space to cursor)."""
        if self._iterable_mode:
            return None
        if self._resume is not None:
            # armed-but-unconsumed resume: the pending position IS the
            # current position (a grace save taken before the first
            # resumed batch must re-save the restored cursor, not a
            # stale local one)
            return {k: v for k, v in self._resume.items()}
        sd = {"epoch": int(self._epoch), "batch": int(self._pos_batch)}
        if hasattr(self.batch_sampler, "state_dict"):
            sd["sampler"] = self.batch_sampler.state_dict()
        return sd

    def load_state_dict(self, sd):
        """Arm the NEXT iteration to resume at the saved position: the
        sampler re-draws the saved epoch's permutation from its
        checkpointed rng state and the first `batch` index-batches are
        skipped at the sampler level (no dataset/collate work). A cursor
        at end-of-epoch advances the shuffle stream past that epoch and
        falls through to a fresh one."""
        if sd is None or self._iterable_mode:
            return
        self._resume = {k: v for k, v in sd.items()}

    def roll_resumed_epoch(self):
        """Treat the armed resume position as end-of-epoch. The caller's
        epoch was truncated at a batch count the loader can't see (hapi
        fit's steps= cap): the next iteration must draw AND DISCARD that
        epoch's permutation — advancing the shuffle stream exactly as
        the uninterrupted run's next epoch would — and start the
        following epoch fresh, not replay the truncated epoch's tail."""
        if self._resume is None or self._iterable_mode:
            return
        try:
            self._resume["batch"] = len(self.batch_sampler)
        except TypeError:
            self._resume = None   # unsized sampler: start fresh

    def _epoch_indices(self):
        """The index-batch iterable for this iteration, resume applied."""
        import itertools
        skip = 0
        if self._resume is not None:
            sd, self._resume = self._resume, None
            if sd.get("sampler") is not None \
                    and hasattr(self.batch_sampler, "load_state_dict"):
                self.batch_sampler.load_state_dict(sd["sampler"])
            self._epoch = int(sd.get("epoch", 0))
            skip = int(sd.get("batch", 0))
            try:
                total = len(self.batch_sampler)
            except TypeError:
                total = None
            if total is not None and skip >= total:
                # the saved epoch was complete: draw (and discard) its
                # permutation so the shuffle stream advances exactly as
                # the uninterrupted run's would, then start fresh
                for _ in self.batch_sampler:
                    pass
                self._epoch += 1
                skip = 0
        it = iter(self.batch_sampler)
        if skip:
            it = itertools.islice(it, skip, None)
        return it, skip

    def _batches(self, index_batches=None):
        if self._iterable_mode:
            buf = []
            for sample in self.dataset:
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield self.collate_fn(buf)
                    buf = []
            if buf and not self.drop_last:
                yield self.collate_fn(buf)
            return
        if index_batches is None:
            index_batches = iter(self.batch_sampler)
        for indices in index_batches:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _batches_threaded(self, index_batches):
        """Fetch batches with a worker pool; keep `prefetch_factor` in flight."""
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        sentinel = object()
        stop = threading.Event()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor * self.num_workers)

        parent_ctx = _trace.current()

        def fetch(indices):
            # worker-pool span: joins the loader's ambient trace so a
            # slow transform shows up next to the step that starved
            with _trace.span("io/collate", parent=parent_ctx,
                             n=len(indices)):
                return self.collate_fn([self.dataset[i] for i in indices])

        def producer():
            try:
                for indices in index_batches:
                    try:
                        fut = pool.submit(fetch, indices)
                    except RuntimeError:
                        # consumer abandoned the iterator and its finally
                        # block shut the pool down between our iterations
                        return
                    while not stop.is_set():  # bounded put that can abort
                        try:
                            q.put(fut, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        fut.cancel()
                        return
            finally:
                while not stop.is_set():  # sentinel must arrive or be moot
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item.result()
        finally:
            stop.set()  # unblock producer if the consumer bailed early
            try:  # drop buffered futures so queued work doesn't run
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # an abandoned iterator (GeneratorExit) must not leak the
            # pool: cancel queued fetches and JOIN the workers — with
            # wait=False the pool threads lived until process exit
            pool.shutdown(wait=True, cancel_futures=True)
            t.join(timeout=5)

    def _batches_multiprocess(self, index_batches):
        """Forked worker processes; batches re-ordered by index so epoch
        order matches the sampler regardless of worker timing."""
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        tasks = list(enumerate(index_batches))
        index_q = ctx.Queue()
        result_q = ctx.Queue(
            maxsize=max(2, self.prefetch_factor) * self.num_workers)
        workers = [
            ctx.Process(target=_worker_loop,
                        args=(self.dataset, self.collate_fn, index_q,
                              result_q, self.worker_init_fn, wid),
                        daemon=True)
            for wid in range(self.num_workers)]
        for w in workers:
            w.start()
        try:
            for t in tasks:
                index_q.put(t)
            for _ in workers:
                index_q.put(None)
            expected, cache, received = 0, {}, 0
            while received < len(tasks):
                bid, payload = result_q.get()
                received += 1
                if isinstance(payload, _WorkerFailure):
                    raise RuntimeError(
                        f"DataLoader worker failed: {payload.type_name}: "
                        f"{payload.message}\n{payload.tb}")
                cache[bid] = payload
                while expected in cache:
                    yield cache.pop(expected)
                    expected += 1
        finally:
            for w in workers:
                if w.is_alive():
                    w.terminate()
                w.join(timeout=5)

    def __iter__(self):
        if self._iterable_mode:
            for b in self._iter_stream(self._batches()):
                yield _to_torch(b)
            return
        index_batches, skip = self._epoch_indices()
        if self.num_workers > 0:
            if self.use_shared_memory:
                gen = self._batches_multiprocess(index_batches)
            else:
                gen = self._batches_threaded(index_batches)
        else:
            gen = self._batches(index_batches)
        # track the consumed-batch cursor so state_dict() taken at any
        # step names the exact next batch; a full epoch rolls the epoch
        # counter so multi-epoch resumes re-derive later permutations
        self._pos_batch = skip
        for b in self._iter_stream(gen):
            self._pos_batch += 1
            yield _to_torch(b)
        self._epoch += 1
        self._pos_batch = 0

    def _iter_stream(self, gen):
        if not self.use_buffer_reader:
            yield from gen
            return
        # double-buffer: keep one batch ahead so host collation overlaps
        # the device step (BufferedReader semantics)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        stop = threading.Event()
        err = []
        parent_ctx = _trace.current()

        def _next_batch(it, seq):
            # spans the PRODUCTION of one batch (collate/worker wait),
            # the host-side cost the double-buffer exists to hide
            sp = _trace.begin("io/produce_batch", parent=parent_ctx, seq=seq)
            try:
                return next(it)
            except StopIteration:
                _trace.end(sp, discard=True)
                raise
            finally:
                if sp.t1 is None:
                    _trace.end(sp)

        def producer():
            try:
                it, seq = iter(gen), 0
                while True:
                    try:
                        b = _next_batch(it, seq)
                    except StopIteration:
                        break
                    seq += 1
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        gen.close() if hasattr(gen, "close") else None
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                while not stop.is_set():  # sentinel must arrive or be moot
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    break
                yield item
        finally:
            stop.set()  # consumer abandoned mid-epoch: release the producer
            try:  # unblock a producer stuck on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)  # producer closes `gen` on its way out,
            if not t.is_alive():  # which shuts the worker pool down too
                try:
                    gen.close()  # no-op if already closed/exhausted
                except RuntimeError:
                    pass
