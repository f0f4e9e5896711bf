"""SelectedRows, sparse row-slice gradients (paddle_tpu/core/selected_rows.py).

A {rows, values, dense_shape} triple stands in for a mostly-zero dense
tensor: the gradient of an embedding lookup with ``sparse=True``
(reference lookup_table_v2's grad kernel), which the row-wise optimizer
updates consume (SGD, Adam / AdamW ``lazy_mode``) so a large table never
has a dense gradient.

torch's autograd holds a tensor on ``.grad``, so the port's sparse lookup
(``ops/norm_ops._sparse_embedding``, a ``torch.autograd.Function``)
gives the table an uncoalesced sparse COO gradient: the looked-up rows and
their cotangent rows, accumulated across backwards by concatenation, as
``SelectedRows.__add__`` does. ``SelectedRows.of(p.grad)`` is that
gradient as a SelectedRows, and the optimizers read it so; nothing on the
sparse path makes it dense.
"""
from __future__ import annotations

import torch

__all__ = ["SelectedRows"]


class SelectedRows:
    """rows: int64 [n]; values: [n, ...] row payloads; dense_shape: the
    shape of the tensor it abbreviates."""

    __slots__ = ("rows", "values", "dense_shape")

    def __init__(self, rows, values, dense_shape):
        values = torch.as_tensor(values)
        self.rows = torch.as_tensor(rows, device=values.device) \
            .reshape(-1).to(torch.int64)
        self.values = values
        self.dense_shape = tuple(int(s) for s in dense_shape)
        if self.values.shape[0] != self.rows.shape[0]:
            raise ValueError(
                f"rows ({self.rows.shape[0]}) and values "
                f"({self.values.shape[0]}) disagree")

    @staticmethod
    def of(grad):
        """The sparse COO gradient ``grad`` (as left on ``.grad`` by a
        sparse lookup) as a SelectedRows, uncoalesced."""
        return SelectedRows(grad._indices()[0], grad._values(), grad.shape)

    @property
    def height(self):
        return self.dense_shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return self.dense_shape

    @property
    def nbytes(self):
        return self.values.nelement() * self.values.element_size() \
            + self.rows.nelement() * self.rows.element_size()

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.dense_shape != self.dense_shape:
                raise ValueError("SelectedRows shape mismatch")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.dense_shape)
        if other is None:
            return self
        return self.to_dense() + other     # a dense consumer densifies

    __radd__ = __add__

    def coalesce(self):
        """Duplicate rows summed, rows sorted (the reference's MergeAdd)."""
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        summed = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                             dtype=self.values.dtype,
                             device=self.values.device).index_add(
            0, inv, self.values)
        return SelectedRows(uniq, summed, self.dense_shape)

    def to_dense(self):
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add(0, self.rows, self.values)

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"SelectedRows(rows={self.rows.shape[0]}, "
                f"dense_shape={self.dense_shape}, dtype={self.dtype})")
