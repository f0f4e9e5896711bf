"""Samplers (paddle_tpu/io/sampler.py), copied: shuffles are numpy
``RandomState`` draws, so the port and the JAX package draw the same
order from the same seed.

Exact resume: a shuffling sampler snapshots its RNG state at the start
of each epoch's draw, and ``state_dict()`` / ``load_state_dict()`` round
trip it, so a restarted trainer re-draws the permutation the stopped one
was walking and a mid-epoch resume replays the same batches.
"""
from __future__ import annotations

import math

import numpy as np


def _rng_state_dict(state):
    """np.random RandomState tuple -> checkpointable {key, pos} (arrays
    and ints only: orbax-serializable, hash-stable)."""
    if state is None:
        return None
    _, key, pos, _, _ = state
    return {"key": np.asarray(key, np.uint32), "pos": int(pos)}


def _rng_state_tuple(sd):
    return ("MT19937", np.asarray(sd["key"], np.uint32), int(sd["pos"]),
            0, 0.0)

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """`generator` may be an int seed or a np.random.RandomState: the
    sampler then owns a PRIVATE stream (required for exact mid-epoch
    resume — the global np.random stream is consumed by model init and
    cannot be replayed). Default None keeps the legacy global-stream
    draw; resume support still snapshots the state it drew from."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        if isinstance(generator, (int, np.integer)):
            generator = np.random.RandomState(int(generator))
        self._rng = generator
        self._pending_state = None   # installed by load_state_dict
        self._epoch_state = None     # state the CURRENT epoch drew from

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def _draw_rng(self):
        """The stream this epoch draws from, with its start-state
        snapshotted (and a pending resume state installed first)."""
        rng = self._rng if self._rng is not None else np.random
        if self._pending_state is not None:
            if self._rng is None:
                # resuming a global-stream sampler: replay through a
                # private stream so the global chain is left alone
                self._rng = rng = np.random.RandomState()
            rng.set_state(_rng_state_tuple(self._pending_state))
            self._pending_state = None
        self._epoch_state = _rng_state_dict(rng.get_state())
        return rng

    def __iter__(self):
        n = len(self.data_source)
        rng = self._draw_rng()
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples

    # -- exact resume --------------------------------------------------------
    def state_dict(self):
        return {} if self._epoch_state is None \
            else {"rng": self._epoch_state}

    def load_state_dict(self, sd):
        if sd and sd.get("rng") is not None:
            self._pending_state = sd["rng"]


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype="float64")
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # -- exact resume (delegates to the index sampler) -----------------------
    def state_dict(self):
        if hasattr(self.sampler, "state_dict"):
            return {"sampler": self.sampler.state_dict()}
        return {}

    def load_state_dict(self, sd):
        if sd.get("sampler") and hasattr(self.sampler, "load_state_dict"):
            self.sampler.load_state_dict(sd["sampler"])


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler (reference:
    python/paddle/fluid/dataloader/batch_sampler.py DistributedBatchSampler).
    Each rank walks every ``nranks``-th index of the (padded) epoch; the
    world size and rank default to ``distributed/env.py``'s readers.
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import env as dist_env
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas or dist_env.get_world_size()
        self.local_rank = rank if rank is not None else dist_env.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - n]  # pad to even shards
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    # -- exact resume: the epoch IS the rng seed here ------------------------
    def state_dict(self):
        return {"epoch": int(self.epoch)}

    def load_state_dict(self, sd):
        if "epoch" in sd:
            self.epoch = int(sd["epoch"])
