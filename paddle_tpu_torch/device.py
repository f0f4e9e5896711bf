"""Device policy of the port (paddle_tpu/device.py): the card unless the
caller asks for the CPU.

``set_device`` / ``get_device`` keep Paddle's names: ``"gpu"`` and
``"gpu:N"`` mean CUDA device N, ``"cpu"`` the CPU (``"cuda"`` and
``"cuda:N"`` are taken too). Layers create their parameters, and
``to_tensor`` and the creation ops their tensors, on the current device.
It is the card until ``set_device`` names another; where no card is
present the default raises, so nothing carries on quietly on the CPU.
``resolve_device(device)`` is what an entry point calls: ``None`` means
the current device.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "set_device", "get_device", "device_scope",
           "get_all_devices", "device_count", "is_compiled_with_cuda", "CPUPlace", "CUDAPlace"]

_current = None       # torch.device set by set_device; None = the card


class Place:
    _kind = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Place) and self._kind == other._kind
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self._kind, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    _kind = "cpu"


class CUDAPlace(Place):
    _kind = "gpu"


def _parse(device) -> torch.device:
    """A device spec (Paddle name, torch name or device, Place) -> a
    torch.device."""
    if isinstance(device, torch.device):
        return device
    if isinstance(device, CPUPlace):
        return torch.device("cpu")
    if isinstance(device, CUDAPlace):
        return torch.device("cuda", device.device_id)
    name = str(device).lower()
    if name == "gpu" or name.startswith("gpu:"):
        name = "cuda" + name[3:]
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'gpu' or 'cpu'")
    return dev


def _check(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' or call set_device('cpu') to run "
            "on the CPU")
    return dev


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device``, or the current one
    when it is None. A CUDA request on a machine without a card raises
    RuntimeError."""
    if device is None:
        device = _current if _current is not None else "cuda"
    return _check(_parse(device))


def set_device(device):
    """paddle.set_device: ``"gpu"``, ``"gpu:N"`` or ``"cpu"``. Returns the
    device's Paddle name. A GPU on a machine without one raises."""
    global _current
    _current = _check(_parse(device))
    return get_device()


@contextlib.contextmanager
def device_scope(device):
    """Make ``device`` the current device for the block (a model's
    constructor builds its layers under its ``device=`` argument)."""
    global _current
    prev = _current
    _current = resolve_device(device)
    try:
        yield _current
    finally:
        _current = prev


def get_device() -> str:
    """The current device's Paddle name (``"gpu:0"``, ``"cpu"``); the
    default names the card whether or not one is present."""
    dev = _current if _current is not None else torch.device("cuda", 0)
    if dev.type == "cpu":
        return "cpu"
    return f"gpu:{dev.index if dev.index is not None else 0}"


def get_all_devices():
    """Paddle names of the devices: the cards (``"gpu:N"``), or
    ``["cpu"]`` where there is none."""
    n = torch.cuda.device_count()
    return [f"gpu:{i}" for i in range(n)] if n else ["cpu"]


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()
