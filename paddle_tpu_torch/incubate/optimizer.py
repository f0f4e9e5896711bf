"""paddle.incubate.optimizer (paddle_tpu/incubate/optimizer.py): the
reference's incubate homes of LookAhead and ModelAverage. The
implementations live in ``optimizer/averaging.py``."""
from ..optimizer.averaging import (ExponentialMovingAverage,  # noqa: F401
                                   LookAhead, ModelAverage)

__all__ = ["LookAhead", "ModelAverage", "ExponentialMovingAverage"]
