"""Hand-written CUDA kernels for Hopper (sm_90a), one source each under
``csrc/``, built with nvcc at first use (``_build.py``) and bound with
ctypes. Importing this package builds nothing."""
from .decode_attention import (  # noqa: F401
    decode_attention, decode_attention_ref, paged_attention_ref,
    paged_decode_attention)
from .fused_ce import (  # noqa: F401
    fused_ce, fused_ce_bwd_dh, fused_ce_bwd_dw, fused_ce_bwd_ref,
    fused_ce_fwd, fused_ce_fwd_ref, valid_rows)

KERNELS = (decode_attention, paged_decode_attention, fused_ce_fwd,
           fused_ce_bwd_dh, fused_ce_bwd_dw)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}
