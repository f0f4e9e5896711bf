"""paddle.distributed.ps — parameter-server training
(paddle_tpu/distributed/ps, the JAX package's names).

The reference PS stack (SURVEY.md §2.1 N20-N22): N20
operators/distributed/ (RPC ops, Communicator, parameter_send row
splitting, large_scale_kv), N21 paddle/fluid/distributed/ (PSClient /
PSServer + table layer), N22 framework/fleet/fleet_wrapper.h (sync /
async sparse / dense pull-push).

The design split:
- servers (table.py / server.py) are host-only numpy KV processes — no
  torch, no card; update rules run server-side on push (accessors). Their
  frames are the JAX package's, so either package's client talks to
  either package's server.
- workers keep ALL dense math on the card; only the unbounded sparse
  vocab goes through the PS. `SparseEmbedding` is the seam: pull the rows
  a batch touches into a dense [n, dim] block on the device, run the
  step, push back just those rows' grads — optionally through the async
  `Communicator`. The device tier (`DeviceHashTable` / `HeterPSCache`,
  heter.py) caches hot rows on the card.
"""
from __future__ import annotations

import numpy as np

from .client import Communicator, PSClient
from .embedding import EmbeddingPrefetcher
from .heter import DeviceHashTable, HeterPSCache
from .publish import EmbeddingSnapshotPublisher
from .replica import ReplicaManager
from .rpc import AuthError, ConnectRefused, DeadlineExceeded, FrameError
from .server import PSServer
from .shard_map import ShardMap, ShardMapStale
from .table import (BarrierTable, DenseTable, GeoSparseTable, SparseTable,
                    make_table)

__all__ = ["PSServer", "PSClient", "Communicator", "DenseTable",
           "SparseTable", "GeoSparseTable", "BarrierTable", "make_table",
           "SparseEmbedding", "DeviceHashTable", "HeterPSCache",
           "EmbeddingPrefetcher", "EmbeddingSnapshotPublisher",
           "DeadlineExceeded", "FrameError", "AuthError", "ConnectRefused",
           "ShardMap", "ShardMapStale", "ReplicaManager"]


class SparseEmbedding:
    """PS-backed embedding for vocabularies too large for device memory.

    Reference analog: `lookup_table` with remote prefetch
    (operators/distributed/parameter_prefetch.cc) + sparse push of
    SelectedRows grads (fleet_wrapper.h push_sparse). Here the lookup is
    an explicit pull/push pair around the step, keeping the step itself
    static-shaped and host-callback-free:

        emb = ps.SparseEmbedding(client, table="w2v", dim=64)
        rows = emb.pull(ids)              # paddle Tensor [n_unique, dim]
        ...                               # use rows inside fwd/bwd
        loss.backward()
        emb.push_grad(rows)               # sends rows.grad for those ids

    Duplicate ids in a batch are uniqued on pull; gather back to batch
    positions happens on-device via the returned `index` (so the card does
    the [n_unique, dim] -> [batch, dim] gather, and the reverse scatter
    lands in rows.grad through the normal tape).
    """

    def __init__(self, client, table: str, dim: int,
                 communicator: Communicator | None = None):
        self.client = client
        self.table = table
        self.dim = int(dim)
        self.communicator = communicator
        self._last_ids = None

    def pull(self, ids):
        """ids: int array-like or tensor, any shape -> (rows Tensor
        [n_unique, dim] with stop_gradient=False, index int Tensor of
        ids.shape mapping each position to its row), on the current
        device."""
        from ...core.tensor import to_tensor
        from .client import _host
        ids_np = np.asarray(_host(ids), dtype=np.int64)
        uniq, inv = np.unique(ids_np.reshape(-1), return_inverse=True)
        rows_np = self.client.pull_sparse(self.table, uniq)
        self._last_ids = uniq
        rows = to_tensor(rows_np, stop_gradient=False)
        index = to_tensor(inv.reshape(ids_np.shape).astype(np.int64))
        return rows, index

    def push_grad(self, rows):
        """Push rows.grad (from the last backward) for the pulled ids."""
        if self._last_ids is None:
            raise RuntimeError("push_grad before pull")
        if rows.grad is None:
            raise RuntimeError(
                "rows has no grad — call loss.backward() first (and use "
                "the rows tensor inside the loss computation)")
        from .client import _host
        g = np.asarray(_host(rows.grad), np.float32)
        if self.communicator is not None:
            self.communicator.push_sparse(self.table, self._last_ids, g)
        else:
            self.client.push_sparse_grad(self.table, self._last_ids, g)
        self._last_ids = None
