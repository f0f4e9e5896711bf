"""RaggedTensor, the LoDTensor analog (paddle_tpu/core/ragged.py).

A ragged batch is held packed: ``values`` [total, ...] and ``row_splits``
[n + 1] (the reference's level-0 LoD offsets). It converts losslessly to
and from the padded form (dense [n, maxlen, ...] and ``lengths`` [n]) and
has the reference's ``lod`` / ``recursive_sequence_lengths`` accessors.
The sequence ops over it are ``ops/sequence.py``.

``values`` stays a torch tensor on its device (a port ``Tensor`` keeps its
autograd history); ``row_splits`` is an int32 tensor on the values'
device. The lengths-dependent shapes (``maxlen``, ``from_padded``) are
read on the host, as in the JAX package's eager forms.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["RaggedTensor"]


def _as_torch(x, device=None):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


class RaggedTensor:
    __slots__ = ("values", "row_splits")

    def __init__(self, values, row_splits):
        self.values = _as_torch(values)
        self.row_splits = _as_torch(row_splits).to(
            device=self.values.device, dtype=torch.int32)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_rows(rows):
        """From a list of per-sequence arrays."""
        lengths = [int(np.shape(r)[0]) for r in rows]
        splits = np.zeros(len(rows) + 1, np.int32)
        np.cumsum(lengths, out=splits[1:])
        if not rows:
            return RaggedTensor(torch.zeros((0,)), splits)
        ts = [_as_torch(r) for r in rows]
        return RaggedTensor(torch.cat(ts, 0), splits)

    @staticmethod
    def from_padded(padded, lengths):
        """Inverse of ``to_padded``: the valid prefix of every row."""
        lengths = np.asarray(_host(lengths), np.int64).reshape(-1)
        padded = _as_torch(padded)
        return RaggedTensor.from_rows([padded[i, :int(n)]
                                       for i, n in enumerate(lengths)])

    # -- reference LoD accessors -------------------------------------------
    @property
    def lod(self):
        """Level-0 offsets, the reference LoD table (lod_tensor.h)."""
        return [[int(v) for v in _host(self.row_splits)]]

    def recursive_sequence_lengths(self):
        s = _host(self.row_splits).astype(np.int64)
        return [[int(v) for v in s[1:] - s[:-1]]]

    @property
    def lengths(self):
        return self.row_splits[1:] - self.row_splits[:-1]

    @property
    def nrows(self):
        return int(self.row_splits.shape[0]) - 1

    @property
    def dtype(self):
        return self.values.dtype

    # -- segment ids --------------------------------------------------------
    def segment_ids(self):
        """int64 [total]: the row index of every value."""
        total = self.values.shape[0]
        pos = torch.arange(total, dtype=torch.int32,
                           device=self.values.device)
        return torch.searchsorted(self.row_splits[1:].contiguous(), pos,
                                  right=True).to(torch.int64)

    # -- padded <-> packed --------------------------------------------------
    def to_padded(self, maxlen=None, pad_value=0):
        """Dense [n, maxlen, ...]; positions past a row's length hold
        ``pad_value``. ``maxlen`` defaults to the longest row."""
        lens = self.lengths.to(torch.int64)
        if maxlen is None:
            maxlen = int(lens.max()) if self.nrows else 0
        n = self.nrows
        tail = tuple(self.values.shape[1:])
        dev = self.values.device
        cols = torch.arange(maxlen, device=dev)
        idx = self.row_splits[:-1, None].to(torch.int64) + cols[None, :]
        valid = cols[None, :] < lens[:, None]
        idx = idx.clamp(0, max(self.values.shape[0] - 1, 0))
        out = self.values[idx.reshape(-1)].reshape((n, maxlen) + tail)
        mask = valid.reshape((n, maxlen) + (1,) * len(tail))
        return torch.where(mask, out, torch.as_tensor(
            pad_value, dtype=out.dtype, device=dev))

    def to_list(self):
        s = _host(self.row_splits)
        v = self.values
        return [v[int(s[i]):int(s[i + 1])] for i in range(self.nrows)]

    def __repr__(self):
        return (f"RaggedTensor(nrows={self.nrows}, "
                f"values={tuple(self.values.shape)}, dtype={self.dtype})")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
