"""Text datasets of the port (paddle_tpu/text/datasets): ``LMDataset``,
copied from the JAX package as it is (numpy only, seeded), so both
packages draw byte-identical batches from the same seed. It is an
``io.Dataset``, as the JAX one is, so ``Model.fit`` builds a DataLoader
over it."""
from __future__ import annotations

import numpy as np

from ...io import Dataset

__all__ = ["LMDataset"]


class LMDataset(Dataset):
    """Synthetic masked/causal LM pretraining data (deterministic)."""

    def __init__(self, vocab_size=30522, seq_len=128, n=4096, mode="mlm",
                 mask_prob=0.15, seed=0):
        rng = np.random.RandomState(seed)
        # Zipfian token distribution, like natural text
        ranks = np.arange(1, vocab_size - 4)
        probs = 1.0 / ranks
        probs /= probs.sum()
        self.tokens = (rng.choice(ranks, size=(n, seq_len), p=probs) + 4) \
            .astype("int64")
        self.mode = mode
        self.vocab_size = vocab_size
        if mode == "mlm":
            mask = rng.rand(n, seq_len) < mask_prob
            self.labels = np.where(mask, self.tokens, -100).astype("int64")
            self.inputs = np.where(mask, 3, self.tokens).astype("int64")  # [MASK]=3
        else:  # causal
            self.inputs = self.tokens[:, :-1]
            self.labels = self.tokens[:, 1:]

    def __getitem__(self, idx):
        return self.inputs[idx], self.labels[idx]

    def __len__(self):
        return len(self.inputs)
