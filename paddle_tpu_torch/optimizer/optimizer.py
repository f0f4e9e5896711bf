"""Optimizers (paddle_tpu/optimizer/optimizer.py): the base class and its
twelve rules.

The update is one function over whole dictionaries,
``apply_gradients_pure(params, grads, slots, lr, t, param_meta)`` ->
``(new_params, new_slots)``, in the JAX package's order (:98-138):

1. each grad plus its regularizer's term (``regularizer.L1Decay`` /
   ``L2Decay``; a float ``weight_decay`` is an ``L2Decay``), the term in
   the parameter's dtype rounded to the grad's;
2. the clip (``optimizer/clip.py``) over the grads whose ``need_clip`` is
   on;
3. the rule, on the f32 master where a bf16/f16 parameter has one
   (``multi_precision``; the grad cast to f32 and the parameter
   re-derived from the new master), else on the parameter with the grad
   cast to its dtype. Each rule mirrors the JAX ``_rule`` expression by
   expression: most cast to f32 inside and round the result back; SGD
   works in the parameter's dtype.

``param_meta`` carries JAX's per-parameter options, ``{name: {"lr_ratio",
"regularizer", "need_clip"}}``; the eager ``step()`` reads them from
attributes set on each ``torch.nn.Parameter`` (``optimize_attr =
{"learning_rate": r}``, ``regularizer``, ``need_clip``), as JAX's
``_param_meta`` reads them from its parameters. ``learning_rate`` may be
a float or an ``lr.LRScheduler`` (read at every step; the caller steps
the scheduler).

Missing gradients, as in the JAX package: the eager ``step()`` skips a
parameter whose grad is None (``_collect``): its value and its slots stay
as they are, and it gets no slots until it has a gradient. The pure
update takes a gradient for every parameter (``jax.grad`` returns zeros
for unused ones); a name absent from its ``grads`` counts as ZERO, so an
unused parameter's moments still decay and AdamW still decays its
weights.

``torch.optim`` is not used: its rules differ (Adam's epsilon sits
outside the bias correction here; AdamW decays after the Adam update, on
the f32 master). The arithmetic runs as ``torch._foreach_*`` ops over all
parameters at once (a few multi-tensor kernels per step instead of a
Python loop of small ones); Lamb's and Lars's trust ratios take one norm
per tensor (``torch._foreach_norm``), kept on the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..regularizer import L1Decay, L2Decay
from . import lr as lr_mod

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "Ftrl",
           "Dpsgd"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)
_F32 = torch.float32
# torch's own accessors: a parameter may be the port's Tensor subclass,
# whose ``.grad`` and ``detach`` are Python; the step needs plain tensors
_grad_of = torch.Tensor.grad.__get__
_set_grad = torch.Tensor.grad.__set__
_detach = torch.Tensor.detach


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


def _f32(tensors):
    return _cast(tensors, [_F32] * len(tensors))


def _like(new, old):
    """``new`` rounded to the dtypes of ``old``."""
    return _cast(new, [t.dtype for t in old])


def _in_dtype(x, dtype):
    """The Python float x rounded to ``dtype`` (jnp's ``.astype``)."""
    return float(torch.tensor(x, dtype=_F32).to(dtype))


def _slots_list(slots, key):
    return [s[key] for s in slots]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        self._named = None if parameters is None \
            else _named_parameters(parameters)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, float):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._slots: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, lr_mod.LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        lr = self._learning_rate
        return lr if isinstance(lr, lr_mod.LRScheduler) else None

    # -- slots ---------------------------------------------------------------
    @staticmethod
    def _slot_like(v):
        """Moment buffers stay f32 even for bf16/f16 params."""
        if v.is_floating_point():
            return torch.zeros(v.shape, dtype=_F32, device=v.device)
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
    def _rule(self, xs, gs, slots, lrs, t):
        """Lists in, lists out: xs the values to update (f32 masters or the
        params), gs their grads in the values' dtypes, slots their slot
        dicts (without the master), lrs their learning rates (f32 values,
        lr times each lr_ratio), t the step. Returns (new values in the
        values' dtypes, new slot dicts)."""
        raise NotImplementedError

    def _coupled_decay_default(self):
        return self._weight_decay

    def _regularize(self, names, ps, gs, meta):
        """g + reg.grad_term(p) for every parameter with a regularizer:
        the term in p's dtype, rounded to g's, one multi-tensor add per
        regularizer object."""
        default = self._coupled_decay_default()
        groups = {}
        for i, k in enumerate(names):
            reg = meta.get(k, {}).get("regularizer", default)
            if reg is not None and getattr(reg, "coeff", 1.0):
                groups.setdefault(id(reg), (reg, []))[1].append(i)
        out = list(gs)
        for reg, idx in groups.values():
            pv = [ps[i] for i in idx]
            if isinstance(reg, L1Decay):
                terms = torch._foreach_mul(torch._foreach_sign(pv), reg.coeff)
            elif isinstance(reg, L2Decay):
                terms = torch._foreach_mul(pv, reg.coeff)
            else:                      # any object with grad_term
                terms = [reg.grad_term(v) for v in pv]
            terms = _cast(terms, [gs[i].dtype for i in idx])
            for i, g in zip(idx, torch._foreach_add([gs[i] for i in idx],
                                                    terms)):
                out[i] = g
        return out

    def apply_gradients_pure(self, params, grads, slots, lr, t,
                             param_meta=None, grad_clip=None):
        """(params, grads, slots, lr, step t) -> (new_params, new_slots),
        all ``{name: tensor}``; the inputs are not modified. A name absent
        from ``grads`` (or mapped to None) has a zero gradient.
        ``param_meta``: ``{name: {"lr_ratio": float, "regularizer":
        obj or None, "need_clip": bool}}``. ``grad_clip``: the clip of
        this call in place of the optimizer's (ZeRO's over shards)."""
        meta = param_meta or {}
        clip = self._grad_clip if grad_clip is None else grad_clip
        names = list(params)
        with torch.no_grad():
            ps = [params[k] for k in names]
            gs = [grads.get(k) for k in names]
            gs = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(ps, gs)]
            # 1) regularizer terms
            gs = self._regularize(names, ps, gs, meta)
            # 2) clip, over the grads that take it
            if clip is not None:
                idx = [i for i, k in enumerate(names)
                       if meta.get(k, {}).get("need_clip", True)]
                clipped = clip.apply({names[i]: gs[i]
                                                 for i in idx})
                for i in idx:
                    gs[i] = clipped[names[i]]
            # 3) the rule, on the f32 master where there is one
            sls = [slots.get(k, {}) for k in names]
            masters = [sl.get("master") for sl in sls]
            xs = [p if m is None else m for p, m in zip(ps, masters)]
            gs = _like(gs, xs)
            rests = [{kk: vv for kk, vv in sl.items() if kk != "master"}
                     for sl in sls]
            lr32 = np.float32(lr)
            lrs = [float(lr32 * np.float32(meta.get(k, {}).get("lr_ratio",
                                                                1.0)))
                   for k in names]
            new_xs, new_rests = self._rule(xs, gs, rests, lrs, int(t))
            new_xs = self._decoupled_decay(names, xs, new_xs, lr)
            new_ps = _like(new_xs, ps)
            new_params = dict(zip(names, new_ps))
            new_slots = {}
            for k, m, x, rest in zip(names, masters, new_xs, new_rests):
                ns = dict(rest)
                if m is not None:
                    ns["master"] = x
                new_slots[k] = ns
        return new_params, new_slots

    def _decoupled_decay(self, names, xs, new_xs, lr):
        """Decay applied after the rule (AdamW); none here."""
        return new_xs

    # -- eager step ----------------------------------------------------------
    def _params(self):
        if self._named is None:
            raise ValueError("optimizer constructed without parameters=")
        return [(k, p) for k, p in self._named if p.requires_grad]

    def _collect(self):
        """The trainable parameters that have a grad, ``{name: param}`` in
        order (JAX's ``_collect``)."""
        return {k: p for k, p in self._params() if _grad_of(p) is not None}

    def _param_meta(self, named):
        default = self._coupled_decay_default()
        return {name: {
            "lr_ratio": getattr(p, "optimize_attr", {}).get("learning_rate",
                                                            1.0),
            "regularizer": getattr(p, "regularizer", None) or default,
            "need_clip": getattr(p, "need_clip", True)}
            for name, p in named.items()}

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a ``.grad``; a
        parameter whose grad is None is skipped (JAX's ``_collect``).
        Parameters are overwritten in place, so modules keep their
        Parameter objects."""
        named = self._collect()
        if not named:
            return
        params = {k: _detach(p) for k, p in named.items()}
        grads = {k: _grad_of(p) for k, p in named.items()}
        self._ensure_slots(params)
        self._step_count += 1
        new_params, new_slots = self.apply_gradients_pure(
            params, grads, {k: self._slots[k] for k in params},
            self.get_lr(), self._step_count, self._param_meta(named))
        torch._foreach_copy_(list(named.values()),
                             [new_params[k] for k in named])
        self._slots.update(new_slots)

    def clear_grad(self, set_to_zero=False):
        if self._named is not None:
            for _, p in self._named:
                _set_grad(p, None)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph: backward + step. Static mode (``loss`` a Variable):
        record the backward and optimizer sections into the loss's
        program, which ``static.Executor`` runs (JAX :238-252)."""
        from ..static.program import Variable, default_main_program
        if isinstance(loss, Variable):
            from ..static import append_backward
            plist = parameters or (None if self._named is None
                                   else [p for _, p in self._named])
            pairs = append_backward(loss, parameter_list=plist)
            program = loss.program or default_main_program()
            program.optimizer_section = (self, pairs)
            program._version += 1
            return [], pairs
        loss.backward()
        self.step()
        return [], []

    # -- state ---------------------------------------------------------------
    def state_dict(self):
        """``_step_count``, every slot under ``"{param}/{slot}"`` (a copy)
        and, with a scheduler, ``LR_Scheduler``: the JAX package's keys."""
        out = {"_step_count": self._step_count}
        for pname, slots in self._slots.items():
            for sname, v in slots.items():
                out[f"{pname}/{sname}"] = v.detach().clone()
        sched = self._lr_scheduler
        if sched is not None:
            out["LR_Scheduler"] = sched.state_dict()
        return out

    def set_state_dict(self, state):
        """Load a ``state_dict`` (tensors or numpy arrays); a slot lands on
        its parameter's device where the optimizer knows the parameter."""
        self._step_count = int(state.get("_step_count", 0))
        sched = self._lr_scheduler
        if sched is not None and "LR_Scheduler" in state:
            sched.set_state_dict(state["LR_Scheduler"])
        devices = {k: p.device for k, p in (self._named or [])}
        for key, v in state.items():
            if key in ("_step_count", "LR_Scheduler") or "/" not in key:
                continue
            pname, sname = key.rsplit("/", 1)
            self._slots.setdefault(pname, {})[sname] = _as_tensor(
                v, devices.get(pname, torch.device("cpu")))

    set_dict = set_state_dict


def _as_tensor(v, device):
    """A tensor or a numpy array (ml_dtypes bfloat16 too) as a tensor on
    ``device``."""
    if isinstance(v, torch.Tensor):
        return v.detach().clone().to(device)
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device,
                                                           torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


class SGD(Optimizer):
    """``p - lr * g`` in the parameter's dtype (lr rounded to it)."""

    def _rule(self, xs, gs, slots, lrs, t):
        steps = torch._foreach_mul(gs, [_in_dtype(lr, x.dtype)
                                        for lr, x in zip(lrs, xs)])
        return torch._foreach_sub(xs, steps), [{} for _ in xs]


class Momentum(Optimizer):
    """Heavy-ball momentum, optionally Nesterov; f32 velocity."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots_for(self, name, v):
        return {"velocity": self._slot_like(v)}

    def _rule(self, xs, gs, slots, lrs, t):
        g32 = _f32(gs)
        v = torch._foreach_add(torch._foreach_mul(
            _slots_list(slots, "velocity"), self._momentum), g32)
        if self._nesterov:
            upd = torch._foreach_mul(torch._foreach_add(
                g32, torch._foreach_mul(v, self._momentum)), lrs)
        else:
            upd = torch._foreach_mul(v, lrs)
        new = torch._foreach_sub(_f32(xs), upd)
        return _like(new, xs), [{"velocity": vi} for vi in v]


class Adam(Optimizer):
    """Adam with f32 moments; epsilon outside the bias correction:
    ``step = lr * sqrt(1 - b2^t) / (1 - b1^t)``,
    ``upd = step * m / (sqrt(v) + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, name=None,
                 multi_precision=False):
        if lazy_mode:
            raise NotImplementedError("lazy_mode updates sparse gradients, "
                                      "which the port does not have yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_slots_for(self, name, v):
        return {"moment1": self._slot_like(v), "moment2": self._slot_like(v)}

    def _moments(self, gs, slots):
        b1, b2 = self._beta1, self._beta2
        g32 = _f32(gs)
        m = torch._foreach_add(
            torch._foreach_mul(_slots_list(slots, "moment1"), b1),
            torch._foreach_mul(g32, 1 - b1))
        v = torch._foreach_add(
            torch._foreach_mul(_slots_list(slots, "moment2"), b2),
            torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - b2))
        return g32, m, v

    def _bias_corrections(self, t):
        """(1 - b1^t, 1 - b2^t) in f32, as ``jnp.power(float32(b), t)``."""
        tf = np.float32(t)
        return (np.float32(1) - np.power(np.float32(self._beta1), tf),
                np.float32(1) - np.power(np.float32(self._beta2), tf))

    def _rule(self, xs, gs, slots, lrs, t):
        _, m, v = self._moments(gs, slots)
        bc1, bc2 = self._bias_corrections(t)
        steps = [float(np.float32(lr) * np.sqrt(bc2) / bc1) for lr in lrs]
        denom = torch._foreach_add(torch._foreach_sqrt(v), self._epsilon)
        upd = torch._foreach_div(torch._foreach_mul(m, steps), denom)
        new = torch._foreach_sub(_f32(xs), upd)
        return _like(new, xs), [{"moment1": mi, "moment2": vi}
                                for mi, vi in zip(m, v)]


class AdamW(Adam):
    """Adam with decoupled weight decay ``new - (lr * wd) * old`` after the
    Adam update, on the f32 master where there is one (the parameter is
    re-derived from it, so decaying only the bf16 copy would be lost),
    else on the parameter in its dtype; for every parameter that
    ``apply_decay_param_fun(name)`` accepts (all by default). ``lr`` is the
    step's, without per-parameter ratios, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None, lazy_mode=False, apply_decay_param_fun=None,
                 name=None, multi_precision=False, lr_ratio=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, name, multi_precision)
        self._decoupled_wd = weight_decay if isinstance(weight_decay, float) \
            else getattr(weight_decay, "coeff", 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _coupled_decay_default(self):
        return None   # the decay is decoupled

    def _decoupled_decay(self, names, xs, new_xs, lr):
        wd = self._decoupled_wd
        if not wd:
            return new_xs
        decay = float(np.float32(lr) * np.float32(wd))
        idx = [i for i, k in enumerate(names)
               if self._apply_decay_param_fun is None
               or self._apply_decay_param_fun(k)]
        if not idx:
            return new_xs
        olds = [xs[i] for i in idx]
        dec = torch._foreach_sub(
            [new_xs[i] for i in idx],
            torch._foreach_mul(olds, [_in_dtype(decay, x.dtype)
                                      for x in olds]))
        out = list(new_xs)
        for i, d in zip(idx, dec):
            out[i] = d
        return out


class Adamax(Optimizer):
    """Adam with the infinity norm: ``u = max(b2 * u, |g|)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots_for(self, name, v):
        return {"moment": self._slot_like(v), "inf_norm": self._slot_like(v)}

    def _rule(self, xs, gs, slots, lrs, t):
        b1 = self._beta1
        g32 = _f32(gs)
        m = torch._foreach_add(
            torch._foreach_mul(_slots_list(slots, "moment"), b1),
            torch._foreach_mul(g32, 1 - b1))
        u = torch._foreach_maximum(
            torch._foreach_mul(_slots_list(slots, "inf_norm"), self._beta2),
            torch._foreach_abs(g32))
        bc1 = np.float32(1) - np.power(np.float32(b1), np.float32(t))
        steps = [float(np.float32(lr) / bc1) for lr in lrs]
        upd = torch._foreach_div(torch._foreach_mul(m, steps),
                                 torch._foreach_add(u, self._epsilon))
        new = torch._foreach_sub(_f32(xs), upd)
        return _like(new, xs), [{"moment": mi, "inf_norm": ui}
                                for mi, ui in zip(m, u)]


class Adagrad(Optimizer):
    """``acc += g^2``, ``p -= lr * g / (sqrt(acc) + eps)``. The
    accumulator starts at ``initial_accumulator_value`` in the
    parameter's dtype and is f32 from the first update on, as in the JAX
    package (``jnp.full_like``)."""

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots_for(self, name, v):
        return {"moment": torch.full_like(v, self._init_acc)}

    def _rule(self, xs, gs, slots, lrs, t):
        g32 = _f32(gs)
        acc = torch._foreach_add(_f32(_slots_list(slots, "moment")),
                                 torch._foreach_mul(g32, g32))
        upd = torch._foreach_div(
            torch._foreach_mul(g32, lrs),
            torch._foreach_add(torch._foreach_sqrt(acc), self._epsilon))
        new = torch._foreach_sub(_f32(xs), upd)
        return _like(new, xs), [{"moment": a} for a in acc]


class Adadelta(Optimizer):
    """Adadelta: running averages of g^2 and of the squared update."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _init_slots_for(self, name, v):
        return {"avg_squared_grad": self._slot_like(v),
                "avg_squared_update": self._slot_like(v)}

    def _rule(self, xs, gs, slots, lrs, t):
        rho, eps = self._rho, self._epsilon
        g32 = _f32(gs)
        asu_old = _slots_list(slots, "avg_squared_update")
        asg = torch._foreach_add(
            torch._foreach_mul(_slots_list(slots, "avg_squared_grad"), rho),
            torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - rho))
        # update = -sqrt((asu + eps) / (asg + eps)) * g
        update = torch._foreach_mul(torch._foreach_neg(torch._foreach_sqrt(
            torch._foreach_div(torch._foreach_add(asu_old, eps),
                               torch._foreach_add(asg, eps)))), g32)
        asu = torch._foreach_add(
            torch._foreach_mul(asu_old, rho),
            torch._foreach_mul(torch._foreach_mul(update, update), 1 - rho))
        new = torch._foreach_add(_f32(xs), torch._foreach_mul(update, lrs))
        return _like(new, xs), [
            {"avg_squared_grad": a, "avg_squared_update": u}
            for a, u in zip(asg, asu)]


class RMSProp(Optimizer):
    """RMSProp with momentum, optionally centered."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots_for(self, name, v):
        s = {"mean_square": self._slot_like(v),
             "momentum": self._slot_like(v)}
        if self._centered:
            s["mean_grad"] = self._slot_like(v)
        return s

    def _rule(self, xs, gs, slots, lrs, t):
        rho = self._rho
        g32 = _f32(gs)
        ms = torch._foreach_add(
            torch._foreach_mul(_slots_list(slots, "mean_square"), rho),
            torch._foreach_mul(torch._foreach_mul(g32, g32), 1 - rho))
        outs = [{"mean_square": m} for m in ms]
        if self._centered:
            mg = torch._foreach_add(
                torch._foreach_mul(_slots_list(slots, "mean_grad"), rho),
                torch._foreach_mul(g32, 1 - rho))
            denom = torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_sub(ms, torch._foreach_mul(mg, mg)),
                self._epsilon))
            for o, m in zip(outs, mg):
                o["mean_grad"] = m
        else:
            denom = torch._foreach_sqrt(torch._foreach_add(ms,
                                                           self._epsilon))
        mom = torch._foreach_add(
            torch._foreach_mul(_slots_list(slots, "momentum"),
                               self._momentum),
            torch._foreach_div(torch._foreach_mul(g32, lrs), denom))
        for o, m in zip(outs, mom):
            o["momentum"] = m
        new = torch._foreach_sub(_f32(xs), mom)
        return _like(new, xs), outs


def _trust(num, den):
    """Per tensor, ``num / den`` where both norms are > 0, else 1 (0-d
    tensors, on the device)."""
    return [torch.where((a > 0) & (b > 0), a / b, torch.ones_like(a))
            for a, b in zip(num, den)]


class Lamb(Optimizer):
    """Layer-adaptive Adam: the Adam direction plus ``wd * p``, scaled per
    tensor by ``||p|| / ||r||``. ``exclude_from_weight_decay_fn`` is kept
    and never applied, as in the JAX package (ROADMAP Queue 3)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    _init_slots_for = Adam._init_slots_for
    _moments = Adam._moments
    _bias_corrections = Adam._bias_corrections

    def _rule(self, xs, gs, slots, lrs, t):
        _, m, v = self._moments(gs, slots)
        p32 = _f32(xs)
        bc1, bc2 = self._bias_corrections(t)
        mhat = torch._foreach_div(m, float(bc1))
        vhat = torch._foreach_div(v, float(bc2))
        r = torch._foreach_add(
            torch._foreach_div(mhat, torch._foreach_add(
                torch._foreach_sqrt(vhat), self._epsilon)),
            torch._foreach_mul(p32, self._wd))
        trust = _trust(torch._foreach_norm(p32), torch._foreach_norm(r))
        # p - (lr * trust) * r
        scale = [lr * tr for lr, tr in zip(lrs, trust)]
        new = torch._foreach_sub(p32, torch._foreach_mul(r, scale))
        return _like(new, xs), [{"moment1": mi, "moment2": vi}
                                for mi, vi in zip(m, v)]


class Lars(Momentum):
    """LARS momentum: a per-tensor local lr
    ``coeff * ||p|| / (||g|| + wd * ||p|| + 1e-12)`` on ``g + wd * p``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 lars_coeff=0.001, lars_weight_decay=0.0005, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _rule(self, xs, gs, slots, lrs, t):
        g32, p32 = _f32(gs), _f32(xs)
        w_norm = torch._foreach_norm(p32)
        g_norm = torch._foreach_norm(g32)
        den = [g + self._lars_wd * w + 1e-12 for g, w in zip(g_norm, w_norm)]
        local = [torch.where((w > 0) & (g > 0), self._lars_coeff * w / d,
                             torch.ones_like(w))
                 for w, g, d in zip(w_norm, g_norm, den)]
        eff = torch._foreach_add(g32, torch._foreach_mul(p32, self._lars_wd))
        # mom * velocity + (lr * local_lr) * eff
        v = torch._foreach_add(
            torch._foreach_mul(_slots_list(slots, "velocity"),
                               self._momentum),
            torch._foreach_mul(eff, [lr * lo for lr, lo in zip(lrs, local)]))
        new = torch._foreach_sub(p32, v)
        return _like(new, xs), [{"velocity": vi} for vi in v]


class Ftrl(Optimizer):
    """FTRL-proximal: squared and linear accumulators, l1 / l2 and
    ``lr_power``."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _init_slots_for(self, name, v):
        return {"squared": self._slot_like(v), "linear": self._slot_like(v)}

    def _rule(self, xs, gs, slots, lrs, t):
        g32, p32 = _f32(gs), _f32(xs)
        n = _slots_list(slots, "squared")
        new_n = torch._foreach_add(n, torch._foreach_mul(g32, g32))
        lp = -self._lr_power
        pow_new = torch._foreach_pow(new_n, lp)
        sigma = torch._foreach_div(
            torch._foreach_sub(pow_new, torch._foreach_pow(n, lp)), lrs)
        new_z = torch._foreach_sub(
            torch._foreach_add(_slots_list(slots, "linear"), g32),
            torch._foreach_mul(sigma, p32))
        denom = torch._foreach_add(torch._foreach_div(pow_new, lrs),
                                   2 * self._l2)
        num = torch._foreach_sub(torch._foreach_mul(
            torch._foreach_sign(new_z), self._l1), new_z)
        prox = torch._foreach_div(num, denom)
        new = [torch.where(z.abs() > self._l1, q, torch.zeros_like(q))
               for z, q in zip(new_z, prox)]
        return _like(new, xs), [{"squared": a, "linear": z}
                                for a, z in zip(new_n, new_z)]


class Dpsgd(Optimizer):
    """Differentially private SGD: each grad clipped to norm ``clip``, then
    Gaussian noise ``sigma * clip / batch_size * N(0, 1)`` added. The noise
    comes from a ``torch.Generator`` on the parameter's device seeded from
    (seed, step, the parameter's place in the update), so a run repeats
    itself; the JAX package keys its noise on a hash of the shape string,
    which Python randomizes per process (ROADMAP Queue 3), so the two
    draws differ and only their distribution is shared."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, seed=0, name=None):
        super().__init__(learning_rate, parameters, None, None, name)
        self._clip = clip
        self._batch = batch_size
        self._sigma = sigma
        self._seed = seed

    def _noise(self, x, t, i):
        gen = torch.Generator(device=x.device)
        gen.manual_seed((int(self._seed) * 1_000_003 + int(t)) * 1_000_003
                        + i)
        return torch.randn(x.shape, generator=gen, device=x.device,
                           dtype=_F32)

    def _rule(self, xs, gs, slots, lrs, t):
        g32 = _f32(gs)
        norms = torch._foreach_norm(g32)
        g32 = torch._foreach_div(g32, [torch.clamp_min(n / self._clip, 1.0)
                                       for n in norms])
        amp = self._sigma * self._clip / self._batch
        noise = [amp * self._noise(x, t, i) for i, x in enumerate(xs)]
        upd = torch._foreach_mul(torch._foreach_add(g32, noise), lrs)
        new = torch._foreach_sub(_f32(xs), upd)
        return _like(new, xs), [{} for _ in xs]
