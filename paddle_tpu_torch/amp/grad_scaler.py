"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

``GradScaler`` multiplies the loss (in f32) before ``backward``, divides
the gradients by the scale before the update, skips the update when a
gradient is not finite, and adapts the scale: times ``decr_ratio``
(never below 1) after ``decr_every_n_nan_or_inf`` bad steps, times
``incr_ratio`` after ``incr_every_n_steps`` good ones.

Two places run it, as in the reference:

- the eager loop: ``scaler.scale(loss).backward()`` then
  ``scaler.step(opt)`` / ``scaler.update()`` (or ``minimize``); the
  unscale is one pass over every gradient with one host sync for the
  found-inf flag;
- ``jit.TrainStep(..., scaler=scaler)``: the step keeps the scale and
  the counters as device tensors of its own, updated in place
  (:func:`scaler_state_in`, :func:`device_unscale`, :func:`device_adapt`),
  never waits on the host for found-inf, and the scaler reads them back
  only when asked (``get_loss_scaling``, ``state_dict``: the reference's
  ``_dev_state``).

The unscale is ``(g.float() * (1 / scale)).to(g.dtype)``, in place
(``device_unscale``).
"""
from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        # (scale f32, good int32, bad int32) on the device while a
        # TrainStep owns the state; None when the host fields are current
        self._dev_state = None

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def _sync_from_device(self):
        """Read the step's device state into the host fields (a host sync,
        only when a value is read)."""
        if self._dev_state is not None:
            s, g, b = (t.item() for t in self._dev_state)
            self._scale, self._good_steps, self._bad_steps = \
                float(s), int(g), int(b)
            self._dev_state = None

    def get_loss_scaling(self):
        self._sync_from_device()
        return self._scale

    def scale(self, loss):
        """The loss times the scale, multiplied in f32."""
        if not self._enable:
            return loss
        self._sync_from_device()
        return loss.float() * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer``'s parameters by the
        scale in place; one host sync for the found-inf flag."""
        if not self._enable:
            return
        self._sync_from_device()
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        self._unscaled = True
        if not grads:
            self._found_inf = False
            return
        scale = torch.full((), self._scale, dtype=torch.float32,
                           device=grads[0].device)
        self._found_inf = bool(device_unscale(grads, scale))  # the sync

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        self._sync_from_device()
        self._unscaled = False
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        self._sync_from_device()
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        # the loaded state supersedes a step's device state
        self._dev_state = None
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


AmpScaler = GradScaler


# ---------------------------------------------------------------------------
# The step's side (jit.TrainStep): device tensors, no host sync
# ---------------------------------------------------------------------------

@torch.no_grad()
def scaler_state_in(scaler, state):
    """Make ``state``, a step's own (scale f32, good int32, bad int32)
    device tensors, the scaler's device state and bring them up to date:
    from the scaler's previous device state when it is another's, or from
    its host fields by fills (no host-to-device copy, which would wait for
    the device). The step reads and updates them in place, so a CUDA graph
    that captured them stays valid."""
    cur = scaler._dev_state
    if cur is state:
        return state
    if cur is None:
        state[0].fill_(scaler._scale)
        state[1].fill_(scaler._good_steps)
        state[2].fill_(scaler._bad_steps)
    else:
        for t, v in zip(state, cur):
            t.copy_(v)
    scaler._dev_state = state
    return state


def new_scaler_state(device):
    """Uninitialised (scale f32, good int32, bad int32) device tensors for
    :func:`scaler_state_in`."""
    return (torch.empty((), dtype=torch.float32, device=device),
            torch.empty((), dtype=torch.int32, device=device),
            torch.empty((), dtype=torch.int32, device=device))


@torch.no_grad()
def device_unscale(grads, scale):
    """Divide ``grads`` by the f32 device scalar ``scale`` in place,
    ``(g.float() * (1 / scale)).to(g.dtype)``, in one multi-tensor pass
    that also flags a gradient that is not finite; returns that flag as
    a device bool. The flag is taken on the scaled values, which is the
    reference's (on the unscaled ones) while the scale is at least 1."""
    found = torch.zeros((), dtype=torch.float32, device=scale.device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.reciprocal(scale))
    return found > 0


@torch.no_grad()
def device_adapt(scaler, found_inf, state):
    """The reference's ``compiled_select_and_adapt`` on the counters:
    (scale, good, bad) after a step whose found-inf flag is the device
    bool ``found_inf``, by selects on the device. As the reference's
    compiled step, it adapts whatever ``use_dynamic_loss_scaling`` says."""
    scale0, good0, bad0 = state
    bad = torch.where(found_inf, bad0 + 1, 0).to(torch.int32)
    good = torch.where(found_inf, 0, good0 + 1).to(torch.int32)
    dec = bad >= scaler._decr_every
    inc = good >= scaler._incr_every
    scale = torch.where(
        dec, torch.clamp(scale0 * scaler._decr_ratio, min=1.0),
        torch.where(inc, scale0 * scaler._incr_ratio, scale0))
    return (scale, torch.where(inc, 0, good).to(torch.int32),
            torch.where(dec, 0, bad).to(torch.int32))
