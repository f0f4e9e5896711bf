"""paddle.incubate (paddle_tpu/incubate): ``checkpoint`` (the training
checkpoints behind ``Model.fit(auto_checkpoint_dir=...)``). The rest of
the JAX package's incubate tier (``functional.py``, ``optimizer.py``) is
ROADMAP Queue 1 item 9."""
from . import checkpoint  # noqa: F401

__all__ = ["checkpoint"]
