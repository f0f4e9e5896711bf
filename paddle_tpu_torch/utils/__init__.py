"""paddle.utils (paddle_tpu/utils): ``unique_name``, ``LogWriter`` /
``read_scalars`` (``log_writer.py``), ``dlpack``, ``cpp_extension``,
``download`` and ``run_check``."""
from . import cpp_extension, dlpack, download, unique_name  # noqa: F401
from .log_writer import LogWriter, read_scalars  # noqa: F401

__all__ = ["LogWriter", "read_scalars", "unique_name", "run_check",
           "dlpack", "cpp_extension", "download"]


def run_check(device=None):
    """Install check (reference paddle.utils.run_check): print the device
    story, then train a Linear(4, 1) five SGD steps on the current device
    (the card unless the caller asks for the CPU); the loss must fall.
    Returns the device it ran on."""
    import numpy as np
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.device import device_scope, resolve_device

    dev = resolve_device(device)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"paddle_tpu_torch is installed; device={dev} ({name}) "
          f"cuda_devices={n} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    with device_scope(dev):
        paddle.seed(0)
        lin = nn.Linear(4, 1)
        opt = optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
        x = paddle.to_tensor(np.random.RandomState(0).rand(8, 4)
                             .astype("float32"))
        y = paddle.to_tensor(np.random.RandomState(1).rand(8, 1)
                             .astype("float32"))
        before = float(((lin(x) - y) ** 2).mean())
        for _ in range(5):
            loss = ((lin(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        after = float(((lin(x) - y) ** 2).mean())
    if not after < before:
        raise RuntimeError(f"run_check: the loss did not fall on {dev} "
                           f"({before} -> {after})")
    print(f"one-device train step on {dev}: OK")
    print("paddle_tpu_torch run_check passed.")
    return dev
