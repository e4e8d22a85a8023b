"""LR schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``
``LRScheduler``, ``CosineAnnealingDecay``, ``PolynomialDecay`` and
``LinearWarmup``): plain host-side float math, stepped by the caller.
``verbose`` is kept, and in ``state_dict``, as the reference keeps it;
neither prints.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = float(self.get_lr())

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")
                and isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)

    set_dict = set_state_dict
    state_keys = state_dict


class CosineAnnealingDecay(LRScheduler):
    """``eta_min + (base_lr - eta_min) * (1 + cos(pi * epoch / T_max)) / 2``."""

    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class PolynomialDecay(LRScheduler):
    """``(base_lr - end_lr) * (1 - step / decay_steps) ** power + end_lr``,
    the step held at ``decay_steps`` (or, with ``cycle``, decay_steps
    stretched to the next multiple past the step)."""

    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        ds = self.decay_steps
        if self.cycle:
            div = math.ceil(step / ds) if step > 0 else 1
            ds = ds * max(div, 1)
        else:
            step = min(step, ds)
        return ((self.base_lr - self.end_lr)
                * (1 - step / ds) ** self.power + self.end_lr)


class LinearWarmup(LRScheduler):
    """From ``start_lr`` up to ``end_lr`` over ``warmup_steps`` steps, then
    ``learning_rate``: a float, or a scheduler stepped to
    ``epoch - warmup_steps``."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * (
                self.last_epoch / self.warmup_steps) + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after()
        return self.lr_after
