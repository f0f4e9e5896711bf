"""Automatic mixed precision (paddle_tpu/amp/__init__.py).

- ``auto_cast`` / ``amp_guard``: levels O0 (off), O1 (white-list ops in
  the AMP dtype, black-list ops in f32, the rest as their inputs come)
  and O2 (every op in the AMP dtype but the black list), dtype bf16 or
  f16, custom lists;
- ``cast_inputs(op_name, vals)``: the per-op cast. The JAX package casts
  at one place, ``core/tape.record_op``, under each recorded op's name.
  The port casts in its op layer, ``ops/_dispatch.defop``, under the
  same names: every port op, and through them every ``Tensor``
  operator, is a cast point. It runs inside autograd (``Tensor.to`` is
  differentiable), so an f32 leaf gets an f32 gradient;
- loss scaling: ``check_finite_and_unscale``, ``update_loss_scaling`` and
  ``GradScaler`` (scale, unscale, skip the step on inf/nan, grow or shrink
  the scale);
- ``decorate``: O2 casts a model's f32 parameters to the AMP dtype and
  turns on the optimizers' f32 master weights.

GradScaler's pure form (``scale_state`` / ``load_scale_state`` /
``apply_pure``) is what ``hapi.Model``'s step embeds, as the JAX
package's compiled hapi step does: the state stays on the device, and
nothing in it reads found_inf on the host.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..optimizer.optimizer import _cast, _grad_of, _set_grad

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate",
           "white_list", "black_list", "policy_dtype", "cast_inputs",
           "amp_active", "check_finite_and_unscale", "update_loss_scaling"]

# the JAX package's lists, copied
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "einsum", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "linear", "addmm",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "nll_loss", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "sigmoid_cross_entropy_with_logits", "kl_div", "mse_loss", "l1_loss",
    "smooth_l1_loss", "huber_loss", "mean", "sum", "prod", "cumsum",
    "logsumexp", "norm", "p_norm", "erf", "erfinv", "expm1", "sigmoid",
    "cosine_similarity", "softplus", "layer_norm", "batch_norm",
    "instance_norm", "group_norm", "rms_norm", "local_response_norm",
}


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O1"
        self.dtype = torch.bfloat16
        self.white = frozenset(WHITE_LIST)
        self.black = frozenset(BLACK_LIST)


_state = _AmpState()


def _amp_dtype(dtype):
    return torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") \
        else torch.float16


def policy_dtype(name, level, dtype, white=None, black=None):
    """Target dtype for op ``name``'s floating inputs under (level,
    dtype), or None to leave them as they are (O1's gray ops)."""
    black = black if black is not None else BLACK_LIST
    white = white if white is not None else WHITE_LIST
    if name in black:
        return torch.float32
    if level == "O2":
        return dtype
    if name in white:
        return dtype
    return None


def amp_active() -> bool:
    return _state.enabled


def cast_inputs(op_name: str, vals):
    """``vals`` (a list) with every floating tensor cast per the active
    policy for ``op_name``; anything else as it is."""
    if not _state.enabled:
        return vals
    dt = policy_dtype(op_name, _state.level, _state.dtype, _state.white,
                      _state.black)
    if dt is None:
        return vals
    return [v.to(dt) if isinstance(v, torch.Tensor) and v.is_floating_point()
            and v.dtype != dt else v for v in vals]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp level must be O0/O1/O2, got {level!r}")
    prev = (_state.enabled, _state.level, _state.dtype, _state.white,
            _state.black)
    _state.enabled = bool(enable) and level != "O0"
    _state.level = level
    _state.dtype = _amp_dtype(dtype)
    white = set(WHITE_LIST)
    black = set(BLACK_LIST)
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    _state.white = frozenset(white)
    _state.black = frozenset(black)
    try:
        yield
    finally:
        (_state.enabled, _state.level, _state.dtype, _state.white,
         _state.black) = prev


amp_guard = auto_cast


# -- loss scaling ------------------------------------------------------------

def check_finite_and_unscale(grads: dict, scale):
    """(grads, scale) -> (unscaled grads, found_inf as a bool 0-d tensor):
    each grad times ``1 / scale`` in f32, rounded back to its dtype;
    found_inf where any unscaled value is inf or nan. Stays on the
    device."""
    if not grads:
        return {}, torch.zeros((), dtype=torch.bool)
    gs = list(grads.values())
    scale = torch.as_tensor(scale, dtype=torch.float32, device=gs[0].device)
    inv = (1.0 / scale).to(torch.float32)
    unscaled = torch._foreach_mul(_cast(gs, [torch.float32] * len(gs)), inv)
    # 0 * x is 0 for a finite x and nan for inf or nan, and a norm of those
    # is nan exactly where a grad holds an inf or a nan
    probe = torch._foreach_norm(torch._foreach_mul(unscaled, 0.0))
    found = ~torch.isfinite(torch.stack(probe)).all()
    out = _cast(unscaled, [g.dtype for g in gs])
    return dict(zip(grads, out)), found


def update_loss_scaling(scale, good_steps, bad_steps, found_inf, *,
                        incr_ratio, decr_ratio, incr_every_n_steps,
                        decr_every_n_nan_or_inf):
    """(scale, good, bad, found_inf) -> (new scale f32, good int32, bad
    int32), 0-d tensors: after ``incr_every_n_steps`` finite steps in a
    row the scale grows by ``incr_ratio``; after
    ``decr_every_n_nan_or_inf`` non-finite ones it shrinks by
    ``decr_ratio``, to no less than 1."""
    zero = torch.zeros_like(good_steps)
    good = torch.where(found_inf, zero, good_steps + 1)
    bad = torch.where(found_inf, bad_steps + 1, zero)
    grow = good >= incr_every_n_steps
    shrink = bad >= decr_every_n_nan_or_inf
    new_scale = torch.where(
        shrink, torch.clamp_min(scale * decr_ratio, 1.0),
        torch.where(grow, scale * incr_ratio, scale))
    good = torch.where(grow | shrink, zero, good)
    bad = torch.where(shrink, zero, bad)
    return (new_scale.to(torch.float32), good.to(torch.int32),
            bad.to(torch.int32))


class GradScaler:
    """Dynamic loss scaling (paddle_tpu.amp.GradScaler):

        scaler = GradScaler(init_loss_scaling=2 ** 15)
        with auto_cast(level="O2", dtype="float16"):
            loss = model(x)
        scaler.scale(loss).backward()
        scaler.step(optimizer)   # unscale, skip the step on inf/nan
        scaler.update()

    The scale and the good/bad counts are 0-d tensors on the loss's
    device; ``step`` reads found_inf on the host once, to decide. The
    pure form (``scale_state`` / ``apply_pure`` / ``load_scale_state``)
    reads nothing on the host: its caller gates the update on the device
    found_inf it returns."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32)
        self._good = torch.tensor(0, dtype=torch.int32)
        self._bad = torch.tensor(0, dtype=torch.int32)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._dynamic = bool(use_dynamic_loss_scaling)
        self._found_inf = None   # set by unscale_ / step

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return float(self._scale)

    def set_init_loss_scaling(self, v):
        self._scale = torch.tensor(float(v), dtype=torch.float32,
                                   device=self._scale.device)

    def _to(self, device):
        if self._scale.device != device:
            self._scale = self._scale.to(device)
            self._good = self._good.to(device)
            self._bad = self._bad.to(device)

    def scale(self, loss):
        if not self._enable:
            return loss
        self._to(loss.device)
        return loss * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        named = optimizer._collect()
        grads = {k: _grad_of(p) for k, p in named.items()}
        if grads:
            self._to(next(iter(grads.values())).device)
        new_grads, found = check_finite_and_unscale(grads, self._scale)
        for k, p in named.items():
            _set_grad(p, new_grads[k])
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._found_inf is None:
            self.unscale_(optimizer)
        if not bool(self._found_inf):
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        """step + update (the loss has been backpropagated already)."""
        self.step(optimizer)
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            self._found_inf = None
            return
        if self._found_inf is None:
            return
        self._scale, self._good, self._bad = update_loss_scaling(
            self._scale, self._good, self._bad,
            self._found_inf.to(self._scale.device),
            incr_ratio=self._incr_ratio, decr_ratio=self._decr_ratio,
            incr_every_n_steps=self._incr_every_n_steps,
            decr_every_n_nan_or_inf=self._decr_every_n_nan_or_inf)
        self._found_inf = None

    # -- pure form (hapi.Model's step) ----------------------------------------
    def scale_state(self):
        """``{"scale", "good", "bad"}``: the state's 0-d tensors."""
        return {"scale": self._scale, "good": self._good, "bad": self._bad}

    def load_scale_state(self, st):
        self._scale, self._good, self._bad = st["scale"], st["good"], st["bad"]

    def apply_pure(self, grads, state):
        """(scaled grads, state) -> (unscaled grads, found_inf, new state),
        all on the device: the caller keeps the old parameters and slots
        where found_inf holds. With dynamic scaling off the state comes
        back as it went in."""
        if not self._enable:
            dev = state["scale"].device
            return grads, torch.zeros((), dtype=torch.bool, device=dev), state
        new_grads, found = check_finite_and_unscale(grads, state["scale"])
        if self._dynamic:
            s, g, b = update_loss_scaling(
                state["scale"], state["good"], state["bad"], found,
                incr_ratio=self._incr_ratio, decr_ratio=self._decr_ratio,
                incr_every_n_steps=self._incr_every_n_steps,
                decr_every_n_nan_or_inf=self._decr_every_n_nan_or_inf)
            state = {"scale": s, "good": g, "bad": b}
        return new_grads, found, state

    def state_dict(self):
        return {
            "scale": self._scale.detach().cpu().numpy(),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_count": int(self._good),
            "decr_count": int(self._bad),
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def set_state_dict(self, d):
        dev = self._scale.device
        self._scale = torch.tensor(float(d["scale"]), dtype=torch.float32,
                                   device=dev)
        self._good = torch.tensor(int(d.get("incr_count", 0)),
                                  dtype=torch.int32, device=dev)
        self._bad = torch.tensor(int(d.get("decr_count", 0)),
                                 dtype=torch.int32, device=dev)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: every f32 parameter of ``models`` cast to the AMP dtype in
    place (the Parameter objects stay, so optimizers built on them keep
    working); ``optimizers`` keep f32 master weights unless
    ``master_weight`` is False. Returns ``models`` or ``(models,
    optimizers)``, as given."""
    if level not in ("O1", "O2"):
        raise ValueError("decorate level must be O1 or O2")
    amp_dt = _amp_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(amp_dt)
    if optimizers is None:
        return models
    opt_single = not isinstance(optimizers, (list, tuple))
    for opt in [optimizers] if opt_single else list(optimizers):
        if master_weight is not False:
            opt._multi_precision = True
    return models, optimizers
