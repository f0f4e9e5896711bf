"""GPT, the decoder-only causal LM (paddle_tpu/text/models/gpt.py).

``forward`` runs the whole sequence with causal attention and returns the
logits, or with ``labels`` the LM loss through the fused CE head (no
bias). The two cached
passes feed generation and serving: ``_forward_cached`` over per-layer
StaticKVCaches (``generate``), ``_forward_paged`` over the serving pool's
PagedKVCaches (``inference/serving.py``). Parameter names match the JAX
model one to one (``blocks.{i}.attn.qkv_proj.weight``, ``wte.weight``
...), so ``paddle_tpu_torch.bridge.load_jax_params`` can copy weights
across.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import ops
from ...core.rng import sample_tokens
from ...device import device_scope
from ...nn import functional as F
from ...nn.kv_pool import PagedKVCache, write_slots
from ...nn.layer import Dropout, Embedding, LayerNorm, Linear
from ...nn.layer import LayerList, MultiHeadAttention
from ...nn.layer.layers import Layer
from .bert import _bert_init

__all__ = ["GPTConfig", "GPTBlock", "GPT"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 1024
    dropout: float = 0.1

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                         num_heads=2, intermediate_size=128, max_seq_len=128)


class GPTBlock(Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size)
        self.attn = MultiHeadAttention(cfg.hidden_size, cfg.num_heads,
                                       dropout=cfg.dropout)
        self.ln2 = LayerNorm(cfg.hidden_size)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x, cache=None):
        h = self.ln1(x)
        if cache is not None:
            a, cache = self.attn(h, cache=cache)
            x = x + a
        else:
            x = x + self.attn(h, is_causal=True)
        h = self.ln2(x)
        x = x + self.drop(self.fc2(F.gelu(self.fc1(h))))
        return x if cache is None else (x, cache)


class GPT(Layer):
    """GPT built on ``device`` (default: the current device, the card
    unless ``set_device("cpu")``), weights drawn from ``seed``, parameters
    in ``dtype``."""

    def __init__(self, config: GPTConfig = None, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        cfg = config or GPTConfig()
        self.config = cfg
        with device_scope(device):
            self.wte = Embedding(cfg.vocab_size, cfg.hidden_size)
            self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size)
            self.drop = Dropout(cfg.dropout)
            self.blocks = LayerList([GPTBlock(cfg)
                                     for _ in range(cfg.num_layers)])
            self.ln_f = LayerNorm(cfg.hidden_size)
        _bert_init(self, seed)
        self.to(dtype=dtype)

    @property
    def device(self):
        return self.wte.weight.device

    @property
    def dtype(self):
        return self.wte.weight.dtype

    def _logits(self, h):
        """Weight-tied LM head."""
        return ops.matmul(h, self.wte.weight, transpose_y=True)

    def forward(self, input_ids, labels=None):
        """Logits [b, s, V] of every position (causal attention); with
        ``labels`` [b, s] the mean LM loss over labels != -100 through the
        fused, weight-tied CE head instead (no [b * s, V] logits)."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        if labels is not None:
            return F.fused_linear_cross_entropy(x, self.wte.weight, None,
                                                labels, ignore_index=-100)
        return self._logits(x)

    def _forward_cached(self, input_ids, caches, index):
        """One cached decode/prefill pass. input_ids [b, s_new], caches one
        StaticKVCache per block, ``index`` the host int count of tokens
        already cached. Returns (last-position logits [b, V], caches)."""
        s = input_ids.shape[1]
        pos = index + torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        new_caches = []
        for blk, c in zip(self.blocks, caches):
            x, c = blk(x, cache=c)
            new_caches.append(c)
        x = self.ln_f(x)
        return self._logits(x[:, -1]), new_caches

    def _forward_paged(self, input_ids, caches, last_index=None):
        """One paged decode/prefill pass over the serving arena.
        input_ids [b, s]; caches one PagedKVCache per block, whose
        ``lengths`` [b] carry each slot's fill. ``last_index`` [b] (or
        None = s - 1) picks the position whose logits come back, so a
        bucket-padded prefill reads the real last prompt token. Returns
        (logits [b, V], caches)."""
        b, s = input_ids.shape
        c0 = caches[0]
        lens = c0.lengths
        pos = lens.long()[:, None] + torch.arange(s, device=lens.device)[None]
        # pad rows of a bucketed prefill can run past the cap; their k/v
        # already land in the trash block, so the position only needs to
        # stay in range
        pos = pos.clamp(0, self.config.max_seq_len - 1)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        # the write indices are the same for every layer: compute once
        slots = write_slots(c0.block_tables, lens, s, c0.block_size)
        new_caches = []
        for blk, c in zip(self.blocks, caches):
            x, c = blk(x, cache=PagedKVCache(c.k, c.v, c.block_tables,
                                             c.lengths, slots))
            new_caches.append(c)
        x = self.ln_f(x)
        if last_index is None:
            h = x[:, -1]
        else:
            h = x[torch.arange(b, device=x.device), last_index.long()]
        return self._logits(h), new_caches

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=None, eos_token_id=None, use_cache=True, seed=0):
        """Autoregressive generation; greedy at temperature 0. Returns
        int64 [b, s + new] on the model's device.

        use_cache=True: prefill once, then an eager loop of one-token
        passes over a preallocated StaticKVCache written in place. A row
        that emits ``eos_token_id`` is frozen to it, and once every row
        has finished the remaining passes are skipped.
        use_cache=False: re-forward the growing prefix each step (the
        equality oracle; stops early once every row has finished).

        Sampling draws token position p of every row from
        ``position_seed(seed, p)`` (core/rng.py), as the serve loop does,
        so a request gets the same stream from both."""
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids).to(self.device,
                                                        torch.int64)
        b, s = ids.shape
        max_new = int(max_new_tokens)
        temperature = float(temperature)
        if max_new < 1:
            return ids
        if not use_cache:
            return self._generate_uncached(ids, max_new, temperature, top_k,
                                           eos_token_id, seed)
        total = s + max_new
        if total > self.config.max_seq_len:
            raise ValueError(
                f"generate: prompt {s} + max_new_tokens {max_new} exceeds "
                f"max_seq_len {self.config.max_seq_len}")
        caches = [blk.attn.gen_static_cache(b, total, self.dtype)
                  for blk in self.blocks]
        logits, caches = self._forward_cached(ids, caches, 0)
        finished = torch.zeros(b, dtype=torch.bool, device=self.device)
        toks = []
        for step in range(max_new):
            nxt = sample_tokens(logits, temperature, top_k, [seed] * b,
                                [s + step] * b)
            if eos_token_id is not None:
                nxt = torch.where(finished, torch.full_like(
                    nxt, eos_token_id), nxt)
                finished |= nxt == eos_token_id
            toks.append(nxt)
            if step == max_new - 1:
                break
            if eos_token_id is not None and bool(finished.all()):
                toks.extend([torch.full_like(nxt, eos_token_id)]
                            * (max_new - 1 - step))
                break
            logits, caches = self._forward_cached(nxt[:, None], caches,
                                                  s + step)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)

    def _generate_uncached(self, ids, max_new, temperature, top_k, eos_id,
                           seed):
        b = ids.shape[0]
        finished = torch.zeros(b, dtype=torch.bool, device=ids.device)
        for _ in range(max_new):
            pos = ids.shape[1]
            nxt = sample_tokens(self(ids)[:, -1], temperature, top_k,
                                [seed] * b, [pos] * b)
            if eos_id is not None:
                nxt = torch.where(finished, torch.full_like(nxt, eos_id),
                                  nxt)
                finished |= nxt == eos_id
            ids = torch.cat([ids, nxt[:, None]], dim=1)
            if eos_id is not None and bool(finished.all()):
                break
        return ids
