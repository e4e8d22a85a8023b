"""The train step (counterpart of ``paddle_tpu/jit/bridge.py``
``TrainStep``).

The reference compiles forward, loss, ``jax.value_and_grad``, clipping
and the optimizer update into one XLA program. Here the same sequence
runs eagerly: forward, loss, ``backward``, then the clip and the update
as the fused multi-tensor step (``optimizer/fused.py``: on the card the
``grad_sq_norm`` and ``fused_update`` kernels, the counterpart of the
update inside the reference's program), or, where the reference's
eligibility refuses a plan or ``FLAGS_fused_optimizer`` is off, the
optimizer's gradient clip and ``Optimizer.apply_gradients``. The clip
ignores ``need_clip`` on both, as the reference's
``_clip_grads_functional`` does, and ``apply_decay_param_fun`` sees the
model's parameter names. With ``FLAGS_anomaly_guard`` (read when the
step is built, as the reference reads it at trace time) a non-finite
loss leaves the parameters, master weights, moments and step counters at
their pre-step values: a device predicate the kernel reads (a select on
the per-parameter path); the host never waits for the loss.

With ``scaler`` (an enabled ``amp.GradScaler``; a disabled one is
ignored, as the reference ignores it) the step runs the reference's
compiled dynamic loss scaling: ``backward`` of the loss times the scale
(multiplied in f32), the gradients unscaled before the clip, found-inf
(some unscaled gradient not finite) ORed into that same predicate, so a
step with an overflow changes no parameter, master weight, moment or
step counter, and the scale and its counters adapted by selects on the
device. They stay device tensors between steps; the scaler reads them
back only when a value is asked for, so the host never waits for
found-inf either. The guard still looks at the unscaled loss.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..amp.grad_scaler import device_adapt, device_unscale, scaler_state_in
from ..framework.flags import flag_value
from ..optimizer.fused import _count_dispatch, fused_plan


class TrainStep:
    """Call with the batch tensors; returns the (detached) loss tensor.

    ``loss_fn(*model_outputs, *labels)`` gives a scalar; the first
    ``n_model_inputs`` batch entries feed the model, the rest feed
    ``loss_fn``. Inputs that are not tensors (numpy arrays) are moved to
    the device of the model's first parameter. After a call each
    parameter's ``.grad`` holds its unclipped gradient of that step
    (unscaled, with a ``scaler``).

    ``donate_state`` is taken in the reference's place and changes
    nothing: the reference donates the parameter and optimizer buffers to
    its compiled program, while here the update already runs in place and
    torch has no buffer donation.
    """

    def __init__(self, model, optimizer, loss_fn: Callable,
                 n_model_inputs: int = 1, donate_state: bool = True,
                 scaler=None):
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn
        self._n_in = n_model_inputs
        self._scaler = scaler if (scaler is not None
                                  and scaler.is_enable()) else None
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._p = [p for _, p in named]
        self._p_names = [n for n, _ in named]
        self._guard = bool(flag_value("anomaly_guard"))
        self._device = self._p[0].device if self._p else torch.device("cpu")
        for p in self._p:                 # state exists from the start,
            optimizer._state_of(p)        # as the reference's _fn_init_all
        self._plan = None                 # the fused plan, once built

    @property
    def opt_state(self):
        """Per-parameter optimizer state, in the step's parameter order."""
        return [self._opt._state_of(p) for p in self._p]

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self._device)
        return torch.as_tensor(x, device=self._device)

    def __call__(self, *batch):
        batch = [self._to_device(x) for x in batch]
        for p in self._p:
            p.grad = None
        outs = self._model(*batch[:self._n_in])
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = self._loss_fn(*outs, *batch[self._n_in:])
        if self._scaler is None:
            loss.backward()
        else:
            sc_state = scaler_state_in(self._scaler, self._device)
            (loss.float() * sc_state[0]).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._p]
        bad = ~torch.isfinite(loss.detach()) if self._guard else None
        if self._scaler is not None:
            found_inf = device_unscale(grads, sc_state[0])
            bad = found_inf if bad is None else bad | found_inf
            self._scaler._dev_state = device_adapt(self._scaler, found_inf,
                                                   sc_state)
        lr = self._opt._lr_operand(self._device)
        self._plan = fused_plan(
            self._opt, self._p, grads, self._p_names, self._plan,
            honour_need_clip=False) if flag_value("fused_optimizer") \
            else None
        if self._plan is not None:
            self._plan.run(grads, lr, bad)
            _count_dispatch(1, "fused")
            return loss.detach()
        clip = self._opt._grad_clip
        if clip is not None:
            grads = clip.clip_grads(grads)
        self._opt.apply_gradients(self._p, grads, lr, self._p_names, bad)
        _count_dispatch(len(self._p), "per_param")
        return loss.detach()
