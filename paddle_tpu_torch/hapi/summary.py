"""The layer table (paddle_tpu/hapi/summary.py ``summary``): one eval
forward of example inputs with a forward hook on every submodule, each
row the submodule's type and path, its output shape and the parameters
it holds itself. ``flops`` (XLA cost analysis in the JAX package) is not
ported."""
from __future__ import annotations

import torch

__all__ = ["summary"]

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def _example_inputs(input_size, dtypes, device):
    from .model import InputSpec

    def norm(one):
        if isinstance(one, InputSpec):
            return list(one.shape), one.dtype
        return list(one), None

    if isinstance(input_size, InputSpec):
        sizes = [norm(input_size)]
    elif isinstance(input_size, (tuple, list)) and input_size and \
            isinstance(input_size[0], (tuple, list, InputSpec)):
        sizes = [norm(s) for s in input_size]
    else:
        sizes = [norm(input_size)]
    dtypes = dtypes or [None] * len(sizes)
    out = []
    for (shape, spec_dt), dt in zip(sizes, dtypes):
        shape = [1 if (d is None or d == -1) else int(d) for d in shape]
        td = dt or spec_dt or "float32"
        td = _DTYPES[td] if isinstance(td, str) else td
        fill = torch.ones if td.is_floating_point else torch.zeros
        out.append(fill(shape, dtype=td, device=device))
    return out


def summary(net, input_size, dtypes=None):
    """Print the table; return ``{"total_params", "trainable_params"}``."""
    rows = []

    def hook(name):
        def fn(mod, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (tuple, list)) \
                else outputs
            shape = list(out.shape) if hasattr(out, "shape") else []
            n = sum(p.numel() for p in mod.parameters(recurse=False))
            rows.append((f"{type(mod).__name__}-{name}", shape, n))
        return fn

    handles = [m.register_forward_hook(hook(name))
               for name, m in net.named_modules() if name]
    modes = [(m, m.training) for m in net.modules()]
    device = next((p.device for p in net.parameters()), torch.device("cpu"))
    net.eval()
    try:
        with torch.no_grad():
            net(*_example_inputs(input_size, dtypes, device))
    finally:
        for h in handles:
            h.remove()
        for m, flag in modes:   # each submodule's own flag, frozen ones too
            m.training = flag
    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    w = max([len(r[0]) for r in rows] + [14]) + 2
    lines = [f"{'Layer (type)':<{w}}{'Output Shape':<22}{'Param #':<12}",
             "-" * (w + 34)]
    for name, shape, n in rows:
        lines.append(f"{name:<{w}}{str(shape):<22}{n:<12,}")
    lines.append("-" * (w + 34))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    lines.append(f"Non-trainable params: {total - trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
