"""Dynamic decoding: Decoder / BeamSearchDecoder / dynamic_decode
(paddle_tpu/nn/decode.py).

Decoding is a host loop of eager steps, bounded by ``max_step_num`` and
ending early once every hypothesis has finished, with the classic beam
bookkeeping: a per-step top-k over the (beam x vocab) joint scores, the
states gathered by parent beam, finished beams frozen on ``end_token``.

Under beam search a ``StaticKVCache`` state is tiled along batch x beam in
``initialize`` and, each step, gathered by parent beam with its host
``index`` kept, so a GPT cell decodes incrementally through the
contiguous decode kernel at batch x beam rows. As in the JAX module, the
bookkeeping stays on the host: the finished mask, the -1e9 first-step
trick (only beam 0 is live at t = 0) and the traceback in ``finalize``.
The parent indices come to the host once a step, for the gather.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..core import tape as _tape
from ..core.tensor import to_tensor
from .layer.transformer import StaticKVCache

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


def _map_states(fn, tree):
    """``fn`` over every tensor and StaticKVCache of a nest of tuples,
    lists and dicts (jax.tree_util.tree_map with those two as leaves);
    anything else is kept as it is."""
    if isinstance(tree, (StaticKVCache, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_states(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_states(fn, v) for k, v in tree.items()}
    return tree


def _first_leaf(tree):
    if isinstance(tree, StaticKVCache):
        return tree.k
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree
    for t in items:
        leaf = _first_leaf(t)
        if leaf is not None:
            return leaf
    return None


class Decoder:
    """Contract: initialize() -> (inputs, states, finished);
    step(time, inputs, states) -> (outputs, states, inputs, finished);
    finalize(outputs, states) -> (outputs, states)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """reference BeamSearchDecoder: expand each batch item to
    ``beam_size`` hypotheses, advance all beams through the cell each
    step, keep the top-k joint log-prob continuations, freeze finished
    beams on ``end_token``."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, inits):
        """inits: the cell's initial states for batch b (a nest of
        [b, ...] tensors and StaticKVCaches)."""
        k = self.beam_size

        def tile(t):
            if isinstance(t, StaticKVCache):
                return StaticKVCache(t.k.repeat_interleave(k, 0),
                                     t.v.repeat_interleave(k, 0), t.index)
            reps = [1, k] + [1] * (t.ndim - 1)
            e = ops.tile(ops.unsqueeze(t, [1]), reps)
            return ops.reshape(e, [-1] + list(e.shape[2:]))

        states = _map_states(tile, inits)
        leaf = _first_leaf(states)
        b = leaf.shape[0] // k
        device = leaf.device
        ids = to_tensor(np.full([b * k], self.start_token, np.int64),
                        place=device)
        # only beam 0 is live at t = 0 (the standard first-step trick)
        neg = np.zeros((b, k), np.float32)
        neg[:, 1:] = -1e9
        self._cum = to_tensor(neg.reshape(-1), place=device)
        self._finished_np = np.zeros(b * k, bool)
        self._batch = b
        return ids, states, to_tensor(self._finished_np, place=device)

    def step(self, time, inputs, states):
        b, k = self._batch, self.beam_size
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        cell_out, new_states = self.cell(emb, states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        logp = ops.log_softmax(logits, axis=-1)            # [b*k, V]
        V = logp.shape[-1]
        fin = self._finished_np
        # finished beams: only end_token continues, at zero added cost
        # (JAX's host mask, applied on the device from the [b*k] flags)
        fin_t = torch.as_tensor(fin).to(logp.device)
        keep = (~fin_t).to(torch.float32)
        is_end = torch.arange(V, device=logp.device) == self.end_token
        mask = torch.where(fin_t[:, None] & ~is_end[None, :],
                           torch.tensor(-1e9, device=logp.device),
                           torch.tensor(0.0, device=logp.device))
        logp = logp * keep[:, None] + mask
        joint = ops.reshape(self._cum[:, None] + logp, [b, k * V])
        top_val, top_idx = ops.topk(joint, k, axis=-1)    # [b, k]
        parent = top_idx // V                              # beam index
        token = top_idx % V                                # vocab id
        flat_parent = (np.arange(b)[:, None] * k
                       + parent.cpu().numpy()).reshape(-1)
        gather_idx = to_tensor(flat_parent.astype(np.int64),
                               place=logp.device)
        # a StaticKVCache reorders its k/v along batch x beam and keeps
        # its host fill index: incremental decoding under beam search
        cache_rows = gather_idx

        def gather_state(t):
            if isinstance(t, StaticKVCache):
                return StaticKVCache(t.k[cache_rows], t.v[cache_rows],
                                     t.index)
            return ops.gather(t, gather_idx)

        new_states = _map_states(gather_state, new_states)
        token_flat = ops.reshape(token, [-1]).astype("int64")
        self._cum = ops.reshape(top_val, [-1])
        token_np = token_flat.cpu().numpy()
        self._finished_np = fin[flat_parent] | (token_np == self.end_token)
        finished = to_tensor(self._finished_np, place=logp.device)
        # per-step outputs for the traceback: (token, parent)
        return (token_flat, to_tensor(flat_parent, place=logp.device)), \
            new_states, token_flat, finished

    def finalize(self, step_outputs, final_states, sequence_lengths):
        """Backtrack the parents into [b, beam, T] token paths; the
        scores are the final beams' joint log-probs [b, beam]."""
        tokens = [t.cpu().numpy() for t, _ in step_outputs]
        parents = [p.cpu().numpy() for _, p in step_outputs]
        T = len(tokens)
        b, k = self._batch, self.beam_size
        n = b * k
        out = np.zeros((T, n), np.int64)
        idx = np.arange(n)
        for t in range(T - 1, -1, -1):
            out[t] = tokens[t][idx]
            idx = parents[t][idx]
        paths = out.T.reshape(b, k, T)
        scores = self._cum.cpu().numpy().reshape(b, k)
        dev = self._cum.device
        return (to_tensor(paths, place=dev), to_tensor(scores, place=dev)), \
            final_states


def dynamic_decode(decoder, inits=None, max_step_num=64, **kwargs):
    """reference dynamic_decode: run decoder.step until every hypothesis
    finishes or ``max_step_num`` is hit. Returns (outputs,
    final_states)."""
    with _tape.no_grad():
        inputs, states, finished = decoder.initialize(inits)
        step_outputs = []
        for t in range(max_step_num):
            out, states, inputs, finished = decoder.step(t, inputs, states)
            step_outputs.append(out)
            if bool(finished.cpu().numpy().all()):
                break
        return decoder.finalize(step_outputs, states, None)
