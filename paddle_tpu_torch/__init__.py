"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` is the reference; this package mirrors its
module paths (``core/tensor.py``, ``ops/math.py``, ``nn/layer/layers.py``,
``text/models/gpt.py`` ...) so a reader can find each counterpart, and
its Paddle surface::

    import paddle_tpu_torch as paddle
    paddle.set_device("gpu")
    x = paddle.to_tensor([[1.0, 2.0]])
    y = paddle.matmul(x, paddle.ones([2, 3]))

It imports torch and never jax or paddle_tpu.

Entry points run on CUDA unless the caller asks for the CPU
(``set_device("cpu")`` or ``device="cpu"``). Every TPU Pallas kernel on a
ported path is a CUDA kernel written by hand (``ops/cuda/csrc``), built
with nvcc at first use; on the CPU the kernels' plain PyTorch versions run
instead.
"""
from __future__ import annotations

from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa: F401
                         float16, float32, float64, int8, int16, int32,
                         int64, uint8)
from .core.dtype import bool_ as bool  # noqa: F401,A001
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.rng import seed  # noqa: F401
from .core.tensor import Tensor, to_tensor  # noqa: F401
from .core.tape import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                        no_grad, set_grad_enabled)
from .device import (CPUPlace, CUDAPlace, device_count,  # noqa: F401
                     get_device, is_compiled_with_cuda, resolve_device,
                     set_device)

from .ops import *  # noqa: F401,F403,E402  paddle.* tensor functions
from . import ops  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import amp, nn, optimizer  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from .nn import ParamAttr  # noqa: F401,E402
from .nn.layer.layers import Parameter  # noqa: F401,E402
from .framework.io import load, save  # noqa: F401,E402
from .hapi import InputSpec, Model  # noqa: F401,E402
from ._legacy_api import *  # noqa: F401,F403,E402  the v1 top-level names
from . import static, jit  # noqa: F401,E402
# the collective tier's registry ops (c_*, send_v2, ring / Ulysses
# attention, the tensor-parallel pair)
from . import distributed  # noqa: F401,E402
from .distributed import collective as _collective  # noqa: F401,E402
from .distributed import ring_attention as _ring  # noqa: F401,E402
from .distributed.fleet import meta_parallel as _mp  # noqa: F401,E402
from .core import flight_recorder as _flight_recorder  # noqa: E402

# with PADDLE_TPU_DUMP_DIR set, SIGTERM / SIGUSR1 write a flight-recorder
# dump (core/flight_recorder.py); unset, nothing is installed
_flight_recorder.maybe_install()


def in_dynamic_mode():
    return not static.in_static_mode()


def enable_static():
    """Record ops into static Programs (``paddle.static``) from here on."""
    static.enable_static_()


def disable_static():
    static.disable_static_()
