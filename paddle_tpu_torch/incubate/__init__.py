"""paddle.incubate (paddle_tpu/incubate): ``checkpoint`` (the training
checkpoints behind ``Model.fit(auto_checkpoint_dir=...)``),
``functional`` (higher-order autodiff over Tensor functions) and
``optimizer`` (LookAhead and ModelAverage), the last two imported at
first use."""
import importlib as _importlib

from . import checkpoint  # noqa: F401

__all__ = ["checkpoint", "functional", "optimizer"]
_SUBMODULES = ("functional", "optimizer")


def __getattr__(name):
    if name in _SUBMODULES:
        mod = _importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(
        f"module 'paddle_tpu_torch.incubate' has no attribute {name!r}")
