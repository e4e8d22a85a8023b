"""LR schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``): the
base ``LRScheduler`` and all 17 of the reference's schedules, plain
host-side float math stepped by the caller (copied from the reference:
it touches no device). ``verbose`` is kept, and in ``state_dict``, as the
reference keeps it; neither prints. ``ReduceOnPlateau.step(metrics)``
reads a tensor metric back to the host.
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


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class MultiplicativeDecay(LRScheduler):
    """The lr times ``lr_lambda(epoch)`` at every step past 0. The running
    product is not in ``state_dict`` (as in the reference):
    ``set_state_dict`` recomputes it from ``lr_lambda``, so a restored
    schedule goes on where the saved one was (the reference's restarts
    from ``learning_rate``)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        self._cur = float(learning_rate)
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch > 0:
            self._cur = self._cur * self.lr_lambda(self.last_epoch)
        return self._cur

    def set_state_dict(self, state_dict):
        super().set_state_dict(state_dict)
        cur = self.base_lr
        for epoch in range(1, self.last_epoch + 1):
            cur = cur * self.lr_lambda(epoch)
        self._cur = cur

    set_dict = set_state_dict


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        t_i = self.T_0
        while t >= t_i:
            t -= t_i
            t_i *= self.T_mult
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * t / t_i)) / 2)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _schedule(self):
        """Phase boundaries as fractional step indices ending at
        ``total_steps - 1`` (``pct * total_steps - 1``, torch's
        convention), derived from the state on every call so that
        ``set_state_dict`` restores a coherent schedule."""
        if self.three_phase:
            bounds = [self.phase_pct * self.total_steps - 1,
                      2 * self.phase_pct * self.total_steps - 2,
                      self.total_steps - 1]
            phases = [(self.initial_lr, self.max_lr),
                      (self.max_lr, self.initial_lr),
                      (self.initial_lr, self.end_lr)]
        else:
            bounds = [self.phase_pct * self.total_steps - 1,
                      self.total_steps - 1]
            phases = [(self.initial_lr, self.max_lr),
                      (self.max_lr, self.end_lr)]
        return bounds, phases

    def _interp(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2
        return (end - start) * pct + start

    def get_lr(self):
        bounds, phases = self._schedule()
        step = min(self.last_epoch, self.total_steps - 1)
        start_step = 0.0
        for i, (bound, (lo, hi)) in enumerate(zip(bounds, phases)):
            if step <= bound or i == len(bounds) - 1:
                denom = max(bound - start_step, 1e-12)
                return self._interp(lo, hi, (step - start_step) / denom)
            start_step = bound
        return self.end_lr


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = self.last_epoch // total
        pos = self.last_epoch % total
        if pos < self.up:
            pct = pos / self.up
        else:
            pct = 1 - (pos - self.up) / self.down
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2 ** cycle)
        elif self.mode == "exp_range":
            amp = amp * (self.exp_gamma ** self.last_epoch)
        return self.base_lr + amp * pct


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        cur = float(metrics) if not hasattr(metrics, "item") else float(metrics.item())
        if self.best is None:
            self.best = cur
            return
        better = cur < self.best - (abs(self.best) * self.threshold
                                    if self.threshold_mode == "rel"
                                    else self.threshold) \
            if self.mode == "min" else \
            cur > self.best + (abs(self.best) * self.threshold
                               if self.threshold_mode == "rel"
                               else self.threshold)
        if better:
            self.best = cur
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0


class LinearLR(LRScheduler):
    """The lr multiplier interpolated linearly from ``start_factor`` to
    ``end_factor`` over ``total_steps``."""

    def __init__(self, learning_rate, total_steps, start_factor=1.0 / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        if total_steps <= 0:
            raise ValueError("total_steps must be positive")
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(max(self.last_epoch, 0), self.total_steps)
        f = (self.start_factor
             + (self.end_factor - self.start_factor) * t / self.total_steps)
        return self.base_lr * f
