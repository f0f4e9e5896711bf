"""BERT, the encoder-only pretraining model of the flagship training step
(paddle_tpu/text/models/bert.py).

``Bert.forward(..., masked_lm_labels=...)`` returns the MLM loss through
the fused CE head (``F.fused_linear_cross_entropy``: the fused CE kernels
on the card, no [b * s, vocab] logits); without labels it returns the
weight-tied logits (and the NSP logits with ``with_nsp``). Parameter
names match the JAX model one to one (``encoder.layers.{i}.self_attn.
qkv_proj.weight``, ``mlm_bias`` ...), so ``bridge.load_jax_params``
copies weights across.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import ops
from ...device import device_scope
from ...nn import functional as F
from ...nn.layer import (CrossEntropyLoss, Dropout, Embedding, LayerNorm,
                         Linear, TransformerEncoder, TransformerEncoderLayer)
from ...nn.layer.layers import Layer

__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "Bert",
           "BertPretrainingCriterion"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def bert_base():
        return BertConfig()

    @staticmethod
    def bert_large():
        return BertConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096)

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=128, max_position_embeddings=128)


def _bert_init(root, seed, std=0.02):
    """Standard BERT init: N(0, std) truncated at two std for matrices and
    tables, unit LayerNorm scale, zero biases; drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``, in parameter order, and
    copied into the parameters where they lie."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in root.named_parameters():
            v = torch.empty(p.shape)
            if p.ndim >= 2:
                torch.nn.init.trunc_normal_(v, 0.0, std, -2 * std, 2 * std,
                                            generator=g)
            elif "weight" in name:            # LayerNorm scale
                v.fill_(1.0)
            else:
                v.zero_()
            torch.Tensor.copy_(p, v)


class BertEmbeddings(Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = self.word_embeddings(input_ids)
        emb = emb + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size)

    def forward(self, hidden_states):
        return ops.tanh(self.dense(hidden_states[:, 0]))


class Bert(Layer):
    """Encoder + MLM head (tied to the word embeddings) + optional NSP
    head, built on ``device`` (default: the current device, the card
    unless ``set_device("cpu")``), weights drawn from ``seed``, parameters
    in ``dtype``."""

    def __init__(self, config: BertConfig = None, with_mlm=True,
                 with_nsp=False, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        cfg = config or BertConfig.bert_base()
        self.config = cfg
        with device_scope(device):
            self.embeddings = BertEmbeddings(cfg)
            enc_layer = TransformerEncoderLayer(
                d_model=cfg.hidden_size, nhead=cfg.num_attention_heads,
                dim_feedforward=cfg.intermediate_size,
                dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
                attn_dropout=cfg.attention_probs_dropout_prob)
            self.encoder = TransformerEncoder(enc_layer,
                                              cfg.num_hidden_layers)
            self.pooler = BertPooler(cfg.hidden_size)
            self.with_mlm = with_mlm
            self.with_nsp = with_nsp
            if with_mlm:
                self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size)
                self.mlm_norm = LayerNorm(cfg.hidden_size,
                                          epsilon=cfg.layer_norm_eps)
                self.mlm_bias = self.create_parameter([cfg.vocab_size],
                                                      is_bias=True)
            if with_nsp:
                self.nsp_head = Linear(cfg.hidden_size, 2)
        _bert_init(self, seed)
        self.to(dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            # [b, s] 1/0 -> additive [b, 1, 1, s], the JAX model's ops (under
            # f16 O2 they run in f16, where -1e9 is -inf)
            m = ops.unsqueeze(ops.cast(attention_mask, "float32"), [1, 2])
            mask = (1.0 - m) * -1e9
        h = self.encoder(x, src_mask=mask)
        outputs = []
        if self.with_mlm:
            t = self.mlm_norm(ops.gelu(self.mlm_transform(h)))
            word = self.embeddings.word_embeddings.weight
            if masked_lm_labels is not None:
                if self.with_nsp:
                    raise ValueError(
                        "masked_lm_labels returns the fused MLM loss only; "
                        "with_nsp models must take the logits path and "
                        "combine losses via BertPretrainingCriterion")
                # fused head: tied-decoder projection + CE, no logits
                return F.fused_linear_cross_entropy(
                    t, word, self.mlm_bias, masked_lm_labels,
                    ignore_index=-100)
            outputs.append(ops.matmul(t, word, transpose_y=True)
                           + self.mlm_bias)
        if self.with_nsp:
            outputs.append(self.nsp_head(self.pooler(h)))
        if not outputs:
            return h
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


class BertPretrainingCriterion(Layer):
    """MLM loss over [b, s, vocab] logits with ignore_index=-100."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size
        self.ce = CrossEntropyLoss(ignore_index=-100)

    def forward(self, prediction_scores, masked_lm_labels):
        b, s, v = prediction_scores.shape
        return self.ce(ops.reshape(prediction_scores, [b * s, v]),
                       ops.reshape(masked_lm_labels, [b * s]))
