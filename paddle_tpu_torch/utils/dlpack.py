"""paddle.utils.dlpack (paddle_tpu/utils/dlpack.py): zero-copy tensor
interchange over the DLPack protocol (reference
python/paddle/utils/dlpack.py to_dlpack / from_dlpack). A CUDA tensor's
round trip keeps its ``data_ptr``."""
from __future__ import annotations

import torch

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """Tensor -> DLPack capsule (sharing its memory)."""
    return torch.utils.dlpack.to_dlpack(x.as_subclass(torch.Tensor)
                                        if isinstance(x, torch.Tensor)
                                        else torch.as_tensor(x))


def from_dlpack(capsule_or_tensor):
    """A DLPack capsule, or any object with ``__dlpack__`` (a numpy array,
    a JAX array, a torch tensor) -> the port's Tensor over the same
    memory."""
    from ..core.tensor import Tensor
    return torch.utils.dlpack.from_dlpack(capsule_or_tensor) \
        .as_subclass(Tensor)
