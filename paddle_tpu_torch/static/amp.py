"""Static-graph AMP (paddle_tpu/static/amp.py; reference
python/paddle/static/amp -> fluid/contrib/mixed_precision/decorator.py).

No cast ops are written into the program: ``decorate`` returns an
optimizer whose ``minimize`` tags the Program with the policy
(``amp_level``, ``amp_dtype``, ``amp_lists``), and the Executor casts each
op's floating inputs at replay (``amp.policy_dtype`` under the JAX op
names, the lists of the eager ``auto_cast``). O2 therefore casts the f32
scope parameters on every step, as the JAX package's static O2 does.

f16 carries dynamic loss scaling in the scope: the Executor scales the
loss, then ``check_finite_and_unscale`` / ``update_loss_scaling`` unscale
the gradients and adapt the scale, and a step whose gradients overflow
leaves the parameters and slots as they were. bf16 carries none.
"""
from __future__ import annotations

import torch

from ..amp import GradScaler, black_list, white_list  # noqa: F401
from .program import default_main_program

__all__ = ["decorate", "CustomOpLists", "AutoMixedPrecisionLists"]


class AutoMixedPrecisionLists:
    """reference fluid/contrib/mixed_precision/fp16_lists.py."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = white_list() | set(custom_white_list or ())
        self.black_list = (black_list() | set(custom_black_list or ())) \
            - set(custom_white_list or ())


CustomOpLists = AutoMixedPrecisionLists


class _AmpOptimizer:
    """Wraps an optimizer so minimize() tags the program with the policy
    (reference decorator.py OptimizerWithMixedPrecision)."""

    def __init__(self, optimizer, amp_lists, level, dtype,
                 use_dynamic_loss_scaling, init_loss_scaling,
                 scaling_hparams=None):
        self._opt = optimizer
        self._amp_lists = amp_lists
        self._level = level
        self._dtype = torch.bfloat16 if str(dtype) in (
            "bfloat16", "bf16", "torch.bfloat16") else torch.float16
        self._dynamic = bool(use_dynamic_loss_scaling) \
            and self._dtype == torch.float16
        self._init_loss_scaling = init_loss_scaling
        self._scaling_hparams = dict(scaling_hparams or {})

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        program = getattr(loss, "program", None) or default_main_program()
        program.amp_level = self._level
        program.amp_dtype = self._dtype
        if self._amp_lists is not None:
            program.amp_lists = (frozenset(self._amp_lists.white_list),
                                 frozenset(self._amp_lists.black_list))
        program.amp_dynamic_scaling = self._dynamic
        program.amp_scaling_hparams = dict(self._scaling_hparams,
                                           init=self._init_loss_scaling)
        return self._opt.minimize(loss, startup_program=startup_program,
                                  parameters=parameters,
                                  no_grad_set=no_grad_set)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def decorate(optimizer, amp_lists=None, level="O1", dtype="bfloat16",
             init_loss_scaling=2.0 ** 15, use_dynamic_loss_scaling=True,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5, **kwargs):
    """paddle.static.amp.decorate: an optimizer whose minimize() enables
    AMP for the whole program (f16 adds in-program dynamic loss
    scaling)."""
    if level not in ("O1", "O2"):
        raise ValueError(f"amp level must be O1/O2, got {level!r}")
    hparams = {"incr_every_n_steps": incr_every_n_steps,
               "decr_every_n_nan_or_inf": decr_every_n_nan_or_inf,
               "incr_ratio": incr_ratio, "decr_ratio": decr_ratio}
    return _AmpOptimizer(optimizer, amp_lists, level, dtype,
                         use_dynamic_loss_scaling, init_loss_scaling,
                         scaling_hparams=hparams)
