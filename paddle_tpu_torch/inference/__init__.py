"""Online inference of the port (paddle_tpu/inference)."""
from .serving import (ServeConfig, ServeLoop, ServeRequest,  # noqa: F401
                      build_decode_step)
