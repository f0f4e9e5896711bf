"""Recompute (activation checkpointing), paddle_tpu/distributed/
recompute.py: ``recompute(fn, *args)`` runs ``fn`` so its activations are
recomputed in the backward instead of kept, through
``torch.utils.checkpoint`` (``use_reentrant=False``; dropout draws the
same numbers in the recomputation, its RNG state restored).

Policies name what is kept: "nothing" (keep nothing, recompute all: the
reference's semantics) and "dots" (keep the matmul outputs, recompute the
elementwise chains between them) as torch's selective-checkpoint policy.
"dots_no_batch" keeps only the matmuls without batch dims in XLA; torch's
policies see op names, not dims, so it raises.
"""
from __future__ import annotations

import torch

__all__ = ["recompute", "checkpoint_policy"]

_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "matmul", "linear", "addmv",
            "mv", "dot", "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_efficient_attention")


def checkpoint_policy(name):
    """None (recompute everything) or a callable for
    ``create_selective_checkpoint_contexts``."""
    if name in (None, "nothing", "nothing_saveable"):
        return None
    if name in ("dots", "dots_saveable"):
        from torch.utils.checkpoint import CheckpointPolicy
        aten = torch.ops.aten
        keep = {getattr(aten, n).default for n in _MATMULS
                if hasattr(aten, n) and hasattr(getattr(aten, n), "default")}

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in keep
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        return policy
    if name in ("dots_no_batch", "dots_with_no_batch_dims_saveable"):
        raise NotImplementedError(
            f"recompute policy {name!r}: torch's selective checkpoint "
            "decides by op, not by the op's batch dims; use 'dots' or "
            "'nothing'")
    raise ValueError(f"unknown recompute policy {name!r}")


def recompute(function, *args, policy="nothing", **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward; with gradients off it is a plain call."""
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    import functools
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    pol = checkpoint_policy(policy)
    extra = {}
    if pol is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, pol)
    return checkpoint(function, *args, use_reentrant=False, **extra,
                      **kwargs)
