"""Hand-written CUDA kernels for Hopper (sm_90a), one source each under
``csrc/``, built with nvcc at first use (``_build.py``) and bound with
ctypes. Importing this package builds nothing.

Dispatch sites that choose between a kernel and a composite record why
(``gate_reject``, counter ``cuda.gate_reject.{kernel}.{reason}``) or that
the kernel engaged (``gate_hit``, counter ``cuda.hit.{kernel}``), as the
JAX package's ``pallas.gate_reject`` / ``pallas.hit`` counters do. There
is no ``run_guarded``: a kernel that fails on the card raises, it is
never demoted to the composite."""
from ...core import monitor, trace
from .decode_attention import (  # noqa: F401
    decode_attention, decode_attention_ref, paged_attention_ref,
    paged_decode_attention)
from .flash_attention import (  # noqa: F401
    flash_attention, flash_bwd_dkv, flash_bwd_dq, flash_bwd_ref, flash_fwd,
    flash_fwd_ref)
from .fused_ce import (  # noqa: F401
    fused_ce, fused_ce_bwd, fused_ce_bwd_dh, fused_ce_bwd_dw,
    fused_ce_bwd_ref, fused_ce_fwd, fused_ce_fwd_ref, valid_rows)

KERNELS = (decode_attention, paged_decode_attention, fused_ce_fwd,
           fused_ce_bwd_dh, fused_ce_bwd_dw, flash_fwd, flash_bwd_dq,
           flash_bwd_dkv)
# wrappers with a second kernel: their launches of it, beside the total
VARIANTS = {"flash_fwd.sm90": flash_fwd, "flash_bwd_dq.sm90": flash_bwd_dq,
            "flash_bwd_dkv.sm90": flash_bwd_dkv,
            "fused_ce_fwd.sm90": fused_ce_fwd,
            "fused_ce_bwd_dh.sm90": fused_ce_bwd_dh,
            "fused_ce_bwd_dw.sm90": fused_ce_bwd_dw,
            "decode_attention.sm90": decode_attention,
            "paged_decode_attention.sm90": paged_decode_attention}
# of the decode wrappers' Hopper launches, those of the chunk (mma) kernel
MMA_VARIANTS = {"decode_attention.mma": decode_attention,
                "paged_decode_attention.mma": paged_decode_attention}
# f16 launches of each wrapper (any of its kernels)
F16_VARIANTS = {f"{k.__name__}.f16": k for k in KERNELS}


def reset_launch_counts():
    """Set every kernel wrapper's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
    for k in VARIANTS.values():
        k.launches_sm90 = 0
    for k in MMA_VARIANTS.values():
        k.launches_mma = 0
    for k in F16_VARIANTS.values():
        k.launches_f16 = 0


def launch_counts():
    """Launches per wrapper (its kernels together); under
    ``<wrapper>.sm90`` those of the Hopper variant, for the decode
    wrappers under ``<wrapper>.mma`` those of its chunk kernel, and under
    ``<wrapper>.f16`` the f16 ones."""
    counts = {k.__name__: k.launches for k in KERNELS}
    counts.update({n: k.launches_sm90 for n, k in VARIANTS.items()})
    counts.update({n: k.launches_mma for n, k in MMA_VARIANTS.items()})
    counts.update({n: k.launches_f16 for n, k in F16_VARIANTS.items()})
    return counts


def gate_reject(kernel: str, reason: str):
    """Record one eligibility-gate rejection; returns False so a gate can
    ``return gate_reject(k, r)``."""
    monitor.stat_add(f"cuda.gate_reject.{kernel}.{reason}")
    trace.instant("cuda/gate_reject", kernel=kernel, reason=reason)
    return False


def gate_hit(kernel: str):
    """Record that a dispatch site engaged its kernel; returns True."""
    monitor.stat_add(f"cuda.hit.{kernel}")
    return True
