"""Device memory introspection (paddle_tpu/memory.py; reference
paddle.device.cuda.memory_allocated / max_memory_allocated and the
allocator facade's stats).

On a CUDA device ``memory_allocated``, ``max_memory_allocated``,
``memory_reserved``, ``stats``, ``empty_cache`` and ``summary`` read (or
drive) torch's caching allocator (``torch.cuda.memory_*``). The CPU has
no allocator statistics: ``memory_allocated`` falls back to
``live_bytes`` and the others give 0 or {}, as the JAX package's do on
its CPU backend.

torch has no ``jax.live_arrays()``, so ``live_bytes`` and
``live_tensor_count`` have a rule of their own: they walk the tensors the
garbage collector tracks, keep those on the device, and count each
untyped storage once (by its data pointer), so views and aliases of one
storage are not counted twice; a storage's bytes are all of it, also
where the live tensors view part of it. Tensors held only by C++ (an
autograd graph's saved tensors, the caching allocator's free blocks) are
not seen.
"""
from __future__ import annotations

import gc
import warnings
from collections import defaultdict

import torch

__all__ = ["memory_allocated", "max_memory_allocated", "memory_reserved",
           "stats", "live_bytes", "live_tensor_count", "summary",
           "empty_cache"]


def _device(device=None) -> torch.device:
    """The device asked for (the current one when None), a card with its
    index."""
    from .device import _parse, resolve_device
    if isinstance(device, int):
        return torch.device("cuda", device)
    dev = resolve_device(None) if device is None else _parse(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def memory_allocated(device=None) -> int:
    """Bytes the allocator holds in tensors on the device now."""
    d = _device(device)
    if d.type == "cuda":
        return int(torch.cuda.memory_allocated(d))
    return live_bytes(d)


def max_memory_allocated(device=None) -> int:
    """The allocator's high-water mark (0 on the CPU)."""
    d = _device(device)
    return int(torch.cuda.max_memory_allocated(d)) if d.type == "cuda" \
        else 0


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds reserved on the card (0 on the
    CPU)."""
    d = _device(device)
    return int(torch.cuda.memory_reserved(d)) if d.type == "cuda" else 0


def stats(device=None) -> dict:
    """The allocator's raw statistics ({} on the CPU)."""
    d = _device(device)
    return dict(torch.cuda.memory_stats(d)) if d.type == "cuda" else {}


def _live_storages(d):
    """{data pointer: (nbytes, dtype name)} of the storages behind the
    gc-tracked tensors on ``d``; and how many such tensors there are."""
    out, n = {}, 0
    with warnings.catch_warnings():   # deprecated module attributes
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.device != d or obj.is_meta:
                continue
            st = obj.untyped_storage()
            ptr = st.data_ptr()
        except Exception:   # a subclass without storage (fake, functional)
            continue
        n += 1
        if ptr and ptr not in out:
            out[ptr] = (st.nbytes(), str(obj.dtype).replace("torch.", ""))
    return out, n


def live_bytes(device=None) -> int:
    """Bytes of the live tensors' storages on the device, each storage
    once (the rule in the module's docstring)."""
    return int(sum(b for b, _ in _live_storages(_device(device))[0]
                   .values()))


def live_tensor_count(device=None) -> int:
    """The gc-tracked tensors on the device (views counted each)."""
    return _live_storages(_device(device))[1]


def empty_cache():
    """Release the caching allocator's free blocks."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def summary(device=None) -> str:
    """A report: the allocator's main counters, then the live storages by
    dtype."""
    d = _device(device)
    st = stats(d)
    lines = [f"memory summary for {d}"]
    for k in ("allocated_bytes.all.current", "allocated_bytes.all.peak",
              "reserved_bytes.all.current", "num_alloc_retries",
              "num_ooms"):
        if k in st:
            lines.append(f"  {k:<32}{st[k]}")
    stores, n = _live_storages(d)
    by_dtype = defaultdict(lambda: [0, 0])
    for nbytes, dt in stores.values():
        by_dtype[dt][0] += 1
        by_dtype[dt][1] += nbytes
    lines.append(f"  live tensors: {n} over {len(stores)} storages "
                 f"({sum(v[1] for v in by_dtype.values()) / 1e6:.2f} MB)")
    for dt, (k, nbytes) in sorted(by_dtype.items(),
                                  key=lambda kv: -kv[1][1]):
        lines.append(f"    {dt:<12}{k:>6} storages {nbytes / 1e6:>10.2f} MB")
    return "\n".join(lines)
