"""Optimizer, Adam and AdamW (paddle_tpu/optimizer/optimizer.py).

The update is one function over whole dictionaries,
``apply_gradients_pure(params, grads, slots, lr, t)`` ->
``(new_params, new_slots)``, as in the JAX package; the eager ``step()``
runs it over the parameters' ``.grad`` and writes the results back in
place. ``torch.optim.AdamW`` is a different rule and is not used:

- ``step_size = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` and
  ``upd = step_size * m / (sqrt(v) + eps)``: epsilon sits outside the
  bias correction;
- AdamW's decoupled decay comes AFTER the Adam update, as
  ``master - lr * wd * old_master`` on the f32 master (or
  ``p - lr * wd * old_p`` without one);
- moments are f32 whatever the parameter dtype, and with
  ``multi_precision`` a bf16/f16 parameter keeps an f32 master slot from
  which the parameter is re-derived every step.

Missing gradients, as in the JAX package: the eager ``step()`` skips a
parameter whose grad is None (``_collect``): its value and its slots stay
as they are, and it gets no slots until it has a gradient. The pure
update takes a gradient for every parameter (``jax.grad`` returns zeros
for unused ones); a name absent from its ``grads`` counts as ZERO, so an
unused parameter's moments still decay and AdamW still decays its
weights. A caller that wants ``bench.py:_build``'s step from ``step()``
(BERT's pooler and token-type table decayed) sets zero grads on the
parameters that autograd left at None first.

The arithmetic runs as ``torch._foreach_*`` ops over all parameters at
once (a few multi-tensor kernels per step instead of a Python loop of
small ones); each op mirrors one jnp expression of the reference, in the
same order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _named_parameters(parameters):
    """(name, tensor) pairs from tensors or from (name, tensor) pairs;
    a bare tensor is named ``param_{i}``."""
    out = []
    for i, p in enumerate(parameters):
        if isinstance(p, tuple):
            out.append((str(p[0]), p[1]))
        else:
            out.append((f"param_{i}", p))
    return out


def _cast(tensors, dtypes):
    """``tensors[i]`` in ``dtypes[i]``: those already in it as they are,
    the rest converted by one multi-tensor copy."""
    idx = [i for i, (t, d) in enumerate(zip(tensors, dtypes)) if t.dtype != d]
    out = list(tensors)
    if idx:
        dst = [torch.empty_like(tensors[i], dtype=dtypes[i]) for i in idx]
        torch._foreach_copy_(dst, [tensors[i] for i in idx])
        for i, d in zip(idx, dst):
            out[i] = d
    return out


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if grad_clip is not None:
            raise NotImplementedError("grad_clip: optimizer/clip.py is not "
                                      "ported yet")
        self._named = None if parameters is None \
            else _named_parameters(parameters)
        self._learning_rate = float(learning_rate)
        # a float weight decay is the coupled L2 term coeff * param
        # (paddle_tpu.regularizer.L2Decay) added to the gradient
        self._l2_coeff = float(getattr(weight_decay, "coeff", weight_decay)
                               or 0.0)
        self._multi_precision = multi_precision
        self._slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    # -- slots ---------------------------------------------------------------
    @staticmethod
    def _slot_like(v):
        """Moment buffers stay f32 even for bf16/f16 params."""
        if v.is_floating_point():
            return torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        return torch.zeros_like(v)

    def _init_slots_for(self, name, value) -> dict:
        """Per-parameter optimizer state; override per optimizer."""
        return {}

    def _ensure_slots(self, params: Dict[str, torch.Tensor]):
        for name, v in params.items():
            if name not in self._slots:
                s = self._init_slots_for(name, v)
                if self._multi_precision and v.dtype in _LOW_PRECISION:
                    s["master"] = v.detach().float().clone()
                self._slots[name] = s

    # -- the update ----------------------------------------------------------
    def _rule(self, xs, gs, slots, lr, t):
        """Lists in, lists out: xs the values to update (f32 masters or the
        params), gs their f32 gradients, slots their slot dicts (without
        the master). Returns (new f32 values, new slot dicts)."""
        raise NotImplementedError

    def apply_gradients_pure(self, params, grads, slots, lr, t):
        """(params, grads, slots, lr, step t) -> (new_params, new_slots),
        all ``{name: tensor}``; the inputs are not modified. A name absent
        from ``grads`` (or mapped to None) has a zero gradient."""
        names = list(params)
        lr = float(lr)
        with torch.no_grad():
            ps = [params[k] for k in names]
            gs = [grads.get(k) for k in names]
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ps, gs)]
            if self._l2_coeff:
                # coupled L2: g + coeff * p, in the grads' dtype
                gs = torch._foreach_add(gs, torch._foreach_mul(
                    ps, self._l2_coeff))
            sls = [slots.get(k, {}) for k in names]
            masters = [sl.get("master") for sl in sls]
            xs = [p if m is None else m for p, m in zip(ps, masters)]
            # the grad is cast to the updated value's dtype first (rounded
            # to bf16 for a bf16 param without a master), then to f32
            f32 = [torch.float32] * len(names)
            gs = _cast([g if g.dtype == x.dtype or x.dtype == torch.float32
                        else g.to(x.dtype) for g, x in zip(gs, xs)], f32)
            rests = [{kk: vv for kk, vv in sl.items() if kk != "master"}
                     for sl in sls]
            new_xs, new_rests = self._rule(_cast(xs, f32), gs, rests, lr, t)
            new_xs = self._decay_f32(names, ps, masters, new_xs, lr)
            new_ps = _cast(new_xs, [p.dtype for p in ps])
            new_ps = self._decay_low_precision(names, ps, masters, new_ps,
                                               lr)
            new_params = dict(zip(names, new_ps))
            new_slots = {}
            for k, m, x, rest in zip(names, masters, new_xs, new_rests):
                ns = dict(rest)
                if m is not None:
                    ns["master"] = x
                new_slots[k] = ns
        return new_params, new_slots

    def _decay_f32(self, names, params, masters, new_xs, lr):
        """Decoupled decay on the f32 values (AdamW); none here."""
        return new_xs

    def _decay_low_precision(self, names, params, masters, new_params, lr):
        """Decoupled decay on low-precision params without a master
        (AdamW); none here."""
        return new_params

    # -- eager step ----------------------------------------------------------
    def _params(self):
        if self._named is None:
            raise ValueError("optimizer constructed without parameters=")
        return [(k, p) for k, p in self._named if p.requires_grad]

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a ``.grad``; a
        parameter whose grad is None is skipped (JAX's ``_collect``).
        Parameters are overwritten in place, so modules keep their
        Parameter objects."""
        named = [(k, p) for k, p in self._params() if p.grad is not None]
        if not named:
            return
        params = {k: p.detach() for k, p in named}
        grads = {k: p.grad for k, p in named}
        self._ensure_slots(params)
        self._step_count += 1
        new_params, new_slots = self.apply_gradients_pure(
            params, grads, {k: self._slots[k] for k in params},
            self.get_lr(), self._step_count)
        torch._foreach_copy_([p for _, p in named],
                             [new_params[k] for k, _ in named])
        self._slots.update(new_slots)

    def clear_grad(self, set_to_zero=False):
        if self._named is not None:
            for _, p in self._named:
                p.grad = None


def _f32(x):
    return np.float32(x)


class Adam(Optimizer):
    """Adam with f32 moments (paddle_tpu Adam ``_rule``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False):
        if lazy_mode:
            raise NotImplementedError("lazy_mode updates sparse gradients, "
                                      "which the port does not have yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slots_for(self, name, v):
        return {"moment1": self._slot_like(v), "moment2": self._slot_like(v)}

    def _rule(self, xs, gs, slots, lr, t):
        b1, b2 = self._beta1, self._beta2
        m = torch._foreach_add(
            torch._foreach_mul([s["moment1"] for s in slots], b1),
            torch._foreach_mul(gs, 1 - b1))
        v = torch._foreach_add(
            torch._foreach_mul([s["moment2"] for s in slots], b2),
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
        # bias corrections in f32, as jnp.power(float32(beta), t)
        tf = _f32(t)
        bc1 = _f32(1) - np.power(_f32(b1), tf)
        bc2 = _f32(1) - np.power(_f32(b2), tf)
        step = float(_f32(lr) * np.sqrt(bc2) / bc1)
        denom = torch._foreach_add(torch._foreach_sqrt(v), self._epsilon)
        upd = torch._foreach_div(torch._foreach_mul(m, step), denom)
        new_xs = torch._foreach_sub(xs, upd)
        return new_xs, [{"moment1": mi, "moment2": vi}
                        for mi, vi in zip(m, v)]


class AdamW(Adam):
    """Adam with decoupled weight decay, applied after the Adam update to
    the f32 master (or to the param without one), for every parameter
    that ``apply_decay_param_fun(name)`` accepts (all by default)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, apply_decay_param_fun=None,
                 multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._decoupled_wd = float(getattr(weight_decay, "coeff",
                                           weight_decay) or 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, names):
        return [self._apply_decay_param_fun is None
                or bool(self._apply_decay_param_fun(k)) for k in names]

    def _decay_f32(self, names, params, masters, new_xs, lr):
        """``new - lr * wd * old`` on every decayed f32 value: the master
        where there is one (the param is re-derived from it, so decaying
        only the bf16 copy would be lost), else an f32 param."""
        wd = self._decoupled_wd
        if not wd:
            return new_xs
        decay = float(_f32(lr) * _f32(wd))     # lr * wd in f32, as jnp
        idx = [i for i, (on, p, m) in enumerate(zip(self._decays(names),
                                                    params, masters))
               if on and (m is not None or p.dtype == torch.float32)]
        if not idx:
            return new_xs
        olds = [params[i].float() if masters[i] is None else masters[i]
                for i in idx]
        dec = torch._foreach_sub([new_xs[i] for i in idx],
                                 torch._foreach_mul(olds, decay))
        out = list(new_xs)
        for i, d in zip(idx, dec):
            out[i] = d
        return out

    def _decay_low_precision(self, names, params, masters, new_params, lr):
        """``new - (lr * wd) * old`` in the param's dtype for a decayed
        bf16/f16 param without a master."""
        wd = self._decoupled_wd
        if not wd:
            return new_params
        decay = float(_f32(lr) * _f32(wd))
        out = list(new_params)
        for i, (on, p, m) in enumerate(zip(self._decays(names), params,
                                           masters)):
            if on and m is None and p.dtype != torch.float32:
                out[i] = new_params[i] - decay * p
        return out
