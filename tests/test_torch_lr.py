"""Port parity: the LR schedulers (paddle_tpu_torch/optimizer/lr.py)
against paddle_tpu.optimizer.lr.

Every scheduler, built with the same arguments in both packages, gives
the same learning rate before and after each of 60 ``step()`` calls
(ReduceOnPlateau: ``step(metric)`` over a scripted metric sequence that
improves, stalls, improves and stalls again). Both are Python float
arithmetic in the same order, so the rates are equal exactly. A
``state_dict`` taken mid-way restores a fresh port scheduler to the same
schedule, and loads into the JAX scheduler too.
"""
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 60

SCHEDULES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, decay_steps=20,
                                                   end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=7, end_lr=0.01, power=1.5, cycle=True),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 17, 40],
                                                 [1.0, 0.5, 0.1, 0.01]),
    "LinearWarmup": lambda m: m.LinearWarmup(0.3, warmup_steps=8,
                                             start_lr=0.0, end_lr=0.3),
    "LinearWarmup_sched": lambda m: m.LinearWarmup(
        m.PolynomialDecay(1e-4, decay_steps=30, end_lr=0.0),
        warmup_steps=10, start_lr=0.0, end_lr=1e-4),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.2, T_max=25,
                                                             eta_min=1e-3),
    "StepDecay": lambda m: m.StepDecay(0.4, step_size=7, gamma=0.5),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.4, milestones=[3, 11, 29],
                                                 gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e
                                           + 0.01 * (e % 3)),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=50),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=40, phase_pct=0.25, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                     step_size_down=9),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=4, mode="exp_range", exp_gamma=0.97),
}


def test_every_scheduler_is_covered():
    names = {k.split("_")[0] for k in SCHEDULES} | {"ReduceOnPlateau"}
    assert names == set(tlr.__all__) - {"LRScheduler"}
    assert tlr.__all__ == jlr.__all__


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    j, t = SCHEDULES[name](jlr), SCHEDULES[name](tlr)
    assert t() == j() and t.last_epoch == j.last_epoch
    for _ in range(STEPS):
        j.step()
        t.step()
        assert t() == j() and t.last_epoch == j.last_epoch
        assert math.isfinite(t())


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_state_dict_round_trip(name):
    t = SCHEDULES[name](tlr)
    for _ in range(23):
        t.step()
    state = t.state_dict()
    fresh, jfresh = SCHEDULES[name](tlr), SCHEDULES[name](jlr)
    fresh.set_state_dict(state)
    jfresh.set_state_dict(dict(state))
    assert fresh() == t() == jfresh()
    for _ in range(10):
        t.step()
        fresh.step()
        jfresh.step()
        assert fresh() == t() == jfresh()


METRICS = ([1.0, 0.9, 0.8, 0.8, 0.81, 0.8, 0.8, 0.79, 0.8, 0.8, 0.8, 0.8]
           + [0.7 - 0.01 * i for i in range(10)]
           + [0.61] * 38)


@pytest.mark.parametrize("kw", [
    dict(mode="min", factor=0.5, patience=2, cooldown=1),
    dict(mode="min", factor=0.5, patience=3, threshold=0.05,
         threshold_mode="abs", min_lr=0.02),
    dict(mode="max", factor=0.2, patience=1, cooldown=2),
])
def test_reduce_on_plateau_matches_jax(kw):
    j = jlr.ReduceOnPlateau(0.1, **kw)
    t = tlr.ReduceOnPlateau(0.1, **kw)
    lrs = []
    assert len(METRICS) == STEPS
    for metric in METRICS:
        j.step(metric)
        t.step(metric)
        assert t() == j()
        assert (t.best, t.num_bad_epochs, t.cooldown_counter) == \
            (j.best, j.num_bad_epochs, j.cooldown_counter)
        lrs.append(t())
    assert len(set(lrs)) > 1          # the rate did drop
    t.step(None)                      # no metric: nothing changes
    assert t() == lrs[-1]
    state = t.state_dict()
    fresh = tlr.ReduceOnPlateau(0.1, **kw)
    fresh.set_state_dict(state)
    assert fresh() == t() and fresh.best == t.best
