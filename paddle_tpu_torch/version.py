"""Version metadata (paddle_tpu/version.py; reference
python/paddle/version.py). The version fields are the JAX package's;
``cuda()`` and ``cudnn()`` report the torch build's CUDA and cuDNN, where
the JAX package's say False."""

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
istaged = False
commit = "unknown"
with_mkl = "OFF"


def show():
    import torch
    print(f"paddle_tpu_torch {full_version}")
    print(f"compute backend: PyTorch {torch.__version__}, CUDA "
          f"{torch.version.cuda or 'none'} (hand-written Hopper kernels; "
          f"CPU for tests)")


def cuda():
    """The CUDA version torch was built with (``torch.version.cuda``), or
    False for a CPU-only build."""
    import torch
    return torch.version.cuda or False


def cudnn():
    """The cuDNN version torch was built with, or False."""
    import torch
    v = torch.backends.cudnn.version() if torch.version.cuda else None
    return v or False


def xpu():
    return False
