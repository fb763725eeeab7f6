"""Learning-rate schedules, the port of ``whisper_finetune_tpu/optim/schedulers.py``.

Each factory returns ``schedule(step) -> multiplier``: a plain Python function
of the integer count of optimizer updates applied so far, returning a float.
The base learning rate is owned by the optimizer, which reads
``base_lr * schedule(count)`` from its own count on the host, so a schedule
costs no device work and no sync.

The arithmetic runs in numpy float32, the JAX package's precision, so that
the restart schedules' ``% 1.0`` and ``floor`` fall on the same side of a
cycle boundary as the reference's; the five schedules agree with it to 1e-6
outside the chill windows.

The "chill" plateau adds uniform noise each step. The JAX package draws it
from ``jax.random`` keyed by the step; here it is a counter-keyed numpy
generator (``default_rng([0x5EED, step])``): deterministic given the step,
the same U(-chill_range, +chill_range) distribution, other numbers.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

Schedule = Callable[[int], float]

_f = np.float32
_PI = _f(np.pi)


def _warm(step, warmup_steps: int):
    return step / _f(max(1.0, float(warmup_steps)))


def _span(warmup_steps: int, train_steps: int):
    return _f(max(1.0, float(train_steps - warmup_steps)))


def linear_with_warmup(warmup_steps: int, train_steps: int) -> Schedule:
    def fn(step: int) -> float:
        step = _f(step)
        if step < warmup_steps:
            return float(_warm(step, warmup_steps))
        decay = (_f(train_steps) - step) / _span(warmup_steps, train_steps)
        return float(max(_f(0.0), decay))

    return fn


def cosine_with_warmup(warmup_steps: int, train_steps: int,
                       num_cycles: float = 0.5) -> Schedule:
    def fn(step: int) -> float:
        step = _f(step)
        if step < warmup_steps:
            return float(_warm(step, warmup_steps))
        progress = (step - _f(warmup_steps)) / _span(warmup_steps, train_steps)
        cos = _f(0.5) * (_f(1.0) + np.cos(_PI * _f(2.0) * _f(num_cycles) * progress))
        return float(max(_f(0.0), cos))

    return fn


def cosine_with_hard_restarts(warmup_steps: int, train_steps: int,
                              num_cycles: int = 1) -> Schedule:
    def fn(step: int) -> float:
        step = _f(step)
        if step < warmup_steps:
            return float(_warm(step, warmup_steps))
        progress = (step - _f(warmup_steps)) / _span(warmup_steps, train_steps)
        if progress >= 1.0:
            return 0.0
        cos = _f(0.5) * (_f(1.0) + np.cos(_PI * ((_f(num_cycles) * progress) % _f(1.0))))
        return float(max(_f(0.0), cos))

    return fn


def _restart_cycle_terms(step: int, warmup_steps: int, train_steps: int,
                         num_cycles: int, gamma: float):
    step = _f(step)
    progress = (step - _f(warmup_steps)) / _span(warmup_steps, train_steps)
    cycle_length = _f(train_steps / num_cycles)
    cycle = np.floor(step / cycle_length)
    max_lr = np.power(_f(gamma), cycle)
    step_in_cycle = step % cycle_length
    cos = max(_f(0.0), _f(0.5) * (_f(1.0) + np.cos(
        _PI * ((_f(num_cycles) * progress) % _f(1.0)))) * max_lr)
    return progress, cycle_length, cycle, max_lr, step_in_cycle, cos


def cosine_with_warmup_restarts(warmup_steps: int, train_steps: int,
                                num_cycles: int = 1, gamma: float = 1.0) -> Schedule:
    """Per-cycle warmup + gamma decay of the cycle's max LR."""

    def fn(step: int) -> float:
        progress, _, _, max_lr, step_in_cycle, cos = _restart_cycle_terms(
            step, warmup_steps, train_steps, num_cycles, gamma)
        if progress >= 1.0:
            return 0.0
        if step_in_cycle < warmup_steps:
            return float(_warm(step_in_cycle, warmup_steps) * max_lr)
        return float(cos)

    return fn


def chill_noise(step: int, chill_range: float) -> float:
    """The chill plateau's noise at ``step``: U(-chill_range, +chill_range)
    from a generator keyed by the step alone."""
    return float(np.random.default_rng([0x5EED, int(step)]).uniform(-chill_range, chill_range))


def cosine_with_warmup_restarts_chill(
    warmup_steps: int,
    train_steps: int,
    num_cycles: int = 1,
    gamma: float = 1.0,
    chill_steps: int = 100,
    chill_range: float = 0.02,
) -> Schedule:
    """Warmup-restarts with a noisy "chill" plateau for the last
    ``chill_steps`` of every non-final cycle: the LR freezes at the value it
    had ``chill_steps - 10`` before the cycle end, jittered by
    U(-chill_range, +chill_range)."""

    def fn(step: int) -> float:
        progress, cycle_length, cycle, max_lr, step_in_cycle, cos = _restart_cycle_terms(
            step, warmup_steps, train_steps, num_cycles, gamma)
        if progress >= 1.0:
            return 0.0
        if step_in_cycle < warmup_steps:
            return float(_warm(step_in_cycle, warmup_steps) * max_lr)
        in_chill = (cycle_length - step_in_cycle) < chill_steps and cycle < num_cycles - 1
        if not in_chill:
            return float(cos)
        last_normal_progress = (
            (cycle_length - _f(chill_steps) + _f(10)) - _f(warmup_steps)
        ) / _span(warmup_steps, train_steps)
        last_normal_lr = max(_f(0.0), _f(0.5) * (_f(1.0) + np.cos(
            _PI * ((_f(num_cycles) * last_normal_progress) % _f(1.0)))) * max_lr)
        return float(last_normal_lr) + chill_noise(step, chill_range)

    return fn


def get_schedule(s_conf: Dict, train_steps: int) -> Schedule:
    """The schedule a config's ``lr_scheduler`` section names; returns a
    multiplier schedule."""
    stype = s_conf["type"]
    warmup = int(s_conf["warmup_steps"])
    if stype == "linear":
        return linear_with_warmup(warmup, train_steps)
    if stype == "cosine":
        return cosine_with_warmup(warmup, train_steps)
    if stype == "cosine_with_restarts":
        return cosine_with_hard_restarts(warmup, train_steps, int(s_conf["lr_num_cycles"]))
    if stype == "cosine_with_warmup_restarts":
        return cosine_with_warmup_restarts(
            warmup, train_steps, int(s_conf["lr_num_cycles"]), float(s_conf["lr_gamma"])
        )
    if stype == "cosine_with_warmup_restarts_chill":
        return cosine_with_warmup_restarts_chill(
            warmup,
            train_steps,
            int(s_conf["lr_num_cycles"]),
            float(s_conf["lr_gamma"]),
            int(s_conf["chill_steps"]),
            float(s_conf["chill_range"]),
        )
    raise ValueError(
        f"Unknown learning rate scheduler: {stype}. Must be linear, cosine, "
        "cosine_with_restarts, cosine_with_warmup_restarts or "
        "cosine_with_warmup_restarts_chill"
    )
