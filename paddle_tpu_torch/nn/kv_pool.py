"""Paged KV-cache pool — the serving tier's shared decode cache
(paddle_tpu/nn/kv_pool.py).

- **arena**: one physical [n_blocks + 1, h, block_size, d] tensor per
  layer per k/v. Physical block 0 is the trash block: writes of idle or
  padded rows and table entries past a request's allocation land there.
- **block table**: request slot i maps logical block j to physical row
  ``block_tables[i, j]``; unallocated entries are 0 by contract.
- **free list**: ``KVBlockPool`` hands physical blocks out and takes them
  back when a request retires; it is the serve loop's admission currency.

Attention over the paged layout is the block-table CUDA kernel
(ops/cuda/decode_attention.paged_decode_attention), whose KV reads scale
with each request's live blocks. ``paged_attention_ref`` is its plain
version and the CPU path.
"""
from __future__ import annotations

import typing

import torch

from ..ops.cuda.decode_attention import (paged_attention_ref,
                                         paged_decode_attention)

__all__ = ["PagedKVCache", "KVBlockPool", "paged_attention",
           "paged_attention_ref", "write_kv", "write_slots",
           "pick_block_size", "TRASH_BLOCK"]

TRASH_BLOCK = 0  # physical row 0 of every arena; never allocated


class PagedKVCache(typing.NamedTuple):
    """One layer's paged decode cache. ``k``/``v`` are the arenas
    [n_blocks + 1, h, block_size, d] (row 0 = trash); ``block_tables``
    [b, max_blocks] int32 maps each slot's logical blocks to physical
    rows; ``lengths`` [b] int32 counts the tokens already written per
    slot. ``slots`` optionally carries ``write_slots`` for this pass, so
    the layers of one forward share one computation of the indices."""

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    slots: typing.Optional[tuple] = None

    @property
    def block_size(self):
        return int(self.k.shape[2])


def _pick_block(n: int, target: int):
    """Largest block <= target among the powers of two 512..8 dividing n
    (paddle_tpu/ops/pallas/flash_attention.py ``_pick_block``)."""
    for b in (target, 512, 256, 128, 64, 32, 16, 8):
        if b <= target and n % b == 0:
            return b
    return None


def pick_block_size(max_seq_len):
    """Pool block size: ``FLAGS_serve_block_size`` if set, else the
    128-column heuristic clamped to the sequence budget. Always a
    multiple of 8. The TPU autotune table is not carried over; the right
    size for the H100 is still to be measured."""
    from ..core import flags as _flags
    cfg = int(_flags.flag("FLAGS_serve_block_size") or 0)
    if cfg:
        if cfg % 8 != 0:
            raise ValueError(
                f"FLAGS_serve_block_size={cfg} must be a multiple of 8")
        return cfg
    L = -(-max(int(max_seq_len), 8) // 8) * 8
    return _pick_block(L, 128) or 8


class KVBlockPool:
    """Host-side free list over the physical arena rows. Not thread-safe:
    the serve loop owns it from one scheduler thread. Block ids are
    1-based (0 is the trash block)."""

    def __init__(self, n_blocks, block_size):
        if n_blocks < 1:
            raise ValueError("KVBlockPool needs at least one block")
        if block_size < 8 or block_size % 8 != 0:
            raise ValueError(
                f"block_size {block_size} must be a multiple of 8 "
                "(the sublane tile of the reference layout)")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # LIFO free list: a just-freed block is reused first
        self._free = list(range(self.n_blocks, 0, -1))

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def used_blocks(self):
        return self.n_blocks - len(self._free)

    def blocks_for(self, n_tokens):
        """Blocks needed to hold n_tokens."""
        return max(0, -(-int(n_tokens) // self.block_size))

    def can_alloc(self, n):
        return len(self._free) >= int(n)

    def alloc(self, n):
        """Pop n physical block ids, or return None and take nothing:
        allocation is all-or-nothing, so a failed admission never leaks."""
        n = int(n)
        if n < 0 or len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks):
        for b in blocks:
            b = int(b)
            if b < 1 or b > self.n_blocks:
                raise ValueError(f"free of invalid block id {b}")
            if b in self._free:  # double-free is a scheduler bug
                raise ValueError(f"double free of block {b}")
            self._free.append(b)

    def arenas(self, layers, heads, head_dim, dtype, device):
        """Fresh zeroed k/v arena pairs, one per layer, each
        [n_blocks + 1, h, block_size, d]. Zeros, not empty: a fresh pool
        must hold finite values everywhere."""
        shape = (self.n_blocks + 1, int(heads), self.block_size,
                 int(head_dim))
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(int(layers))]


def write_slots(block_tables, lengths, s, block_size):
    """Physical (block, offset) of the s new tokens of every slot, each
    [b, s]: the tokens land at logical positions lengths[i] ..
    lengths[i] + s - 1. Positions past a slot's table go to the trash
    block."""
    nb = block_tables.shape[1]
    pos = lengths.long()[:, None] + torch.arange(
        s, device=lengths.device)[None]                         # [b, s]
    blk_raw = torch.div(pos, block_size, rounding_mode="floor")
    blk = blk_raw.clamp(max=nb - 1)
    phys = torch.gather(block_tables.long(), 1, blk)
    phys = torch.where(blk_raw < nb, phys,
                       torch.full_like(phys, TRASH_BLOCK))
    return phys, pos % block_size


def write_kv(arena, block_tables, lengths, new_kv, slots=None):
    """Scatter a chunk's k (or v), ``new_kv`` [b, s, h, d], into the
    arena IN PLACE (the JAX package returns a new arena; here the arena
    is one buffer the serve loop keeps for its lifetime). Returns the
    arena."""
    if slots is None:
        slots = write_slots(block_tables, lengths, new_kv.shape[1],
                            arena.shape[2])
    phys, off = slots
    arena[phys, :, off] = new_kv.to(arena.dtype)
    return arena


def paged_attention(q, k_arena, v_arena, block_tables, lengths, scale):
    """Paged attention: the block-table kernel for CUDA tensors, its
    plain version for CPU tensors."""
    return paged_decode_attention(q, k_arena, v_arena, block_tables,
                                  lengths, scale)
