"""Fused multi-tensor optimizer step (counterpart of
``paddle_tpu/optimizer/fused.py``).

The per-parameter step runs some twenty tensor ops per parameter, each a
launch of its own. The fused step runs the whole update, clip included,
as one pass over every parameter: on the card the hand-written
multi-tensor kernels of ``kernels/fused_optimizer.py`` (``grad_sq_norm``
when the clip is a norm, then one ``fused_update`` launch), on the CPU
their plain versions, which repeat the per-parameter ops tensor by
tensor and so equal that path bit for bit.

Where the reference flattens parameters into dtype buckets and keeps flat
copies of the state (XLA needs a concatenation), the port walks a table
of addresses: the per-parameter master weights, moments and step
counters stay where they are and are updated in place, so ``state_dict``
/ ``set_state_dict`` and checkpoints keep their per-parameter keys and
the plan holds no second copy of anything.

Eligibility is the reference's: a plan is refused, and the per-parameter
path runs, for an optimizer of another type than exactly SGD, Momentum,
Adam or AdamW; a clip of another class; a parameter with
``need_clip=False`` when a clip is set (eager ``step()`` only:
``TrainStep``'s clip ignores the flag, as the reference's does); a
regularizer that is not a number, ``L1Decay`` or ``L2Decay``; an
``lr_ratio`` that raises; step counters that disagree. The port adds one
refusal: parameters on more than one device. The plan is cached on its
signature, which includes the optimizer's state generation (bumped when
the per-parameter path or ``set_state_dict`` replaces state tensors).

The ``dist_*`` building blocks (the reference's ZeRO-1 update) wait for
the distributed port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..framework.flags import flag_value
from ..kernels import fused_optimizer as fk
from ..observability import metrics as _obsm

__all__ = ["try_fused_step", "fused_plan", "FusedPlan", "bucket_coeffs",
           "fused_bucket_update", "dispatch_counts"]

# optimizer update dispatches of eager steps and TrainSteps, by path: one
# per step on the fused path, one per parameter on the per-parameter path
dispatch_counts = {"fused": 0, "per_param": 0}

_opt_dispatches = None


def _count_dispatch(n: int, path: str):
    """``dispatch_counts`` and the reference's ``train.opt_dispatches``
    counter (by path)."""
    global _opt_dispatches
    dispatch_counts[path] += n
    if not _obsm.enabled():
        return
    if _opt_dispatches is None:
        _opt_dispatches = _obsm.counter(
            "train.opt_dispatches",
            help="eager optimizer update programs dispatched")
    _opt_dispatches.inc(n, path=path)


# ---------------------------------------------------------------------------
# Eligibility + per-param coefficients
# ---------------------------------------------------------------------------

def _kind_of(opt) -> Optional[str]:
    # exact types: a subclass may override _fn_apply with math the kernel
    # does not model
    from .optimizer import SGD, Adam, AdamW, Momentum
    return {SGD: "sgd", Momentum: "momentum", Adam: "adam",
            AdamW: "adamw"}.get(type(opt))


def _classify_reg(reg) -> Optional[Tuple[float, float]]:
    """(l2_coeff, l1_coeff) for a regularizer spec, or None if it cannot
    be expressed as elementwise coefficients (custom callables)."""
    from ..regularizer import L1Decay, L2Decay
    if reg is None:
        return (0.0, 0.0)
    if isinstance(reg, L2Decay):
        return (float(reg.coeff), 0.0)
    if isinstance(reg, L1Decay):
        return (0.0, float(reg.coeff))
    if isinstance(reg, (int, float)):
        return (float(reg), 0.0)
    return None


def bucket_coeffs(opt, params, names) -> Optional[dict]:
    """Per-parameter coefficient lists for a fusible optimizer, or None
    when any parameter needs the per-parameter path. Keys: kind, l2[i],
    l1[i] (penalties folded into the gradient), wd[i] (AdamW's decoupled
    decay, 0 where ``apply_decay_param_fun(names[i])`` rejects the
    parameter), lr_scale[i] (AdamW's ``lr_ratio``)."""
    kind = _kind_of(opt)
    if kind is None:
        return None
    n = len(params)
    l2, l1, wd, lr_scale = [0.0] * n, [0.0] * n, [0.0] * n, [1.0] * n
    for i, (p, name) in enumerate(zip(params, names)):
        preg = getattr(p, "regularizer", None)
        if kind == "adamw":
            if preg is not None:
                c = _classify_reg(preg)
                if c is None:
                    return None
                l2[i], l1[i] = c
            fn = opt._apply_decay_param_fun
            wd[i] = 0.0 if fn is not None and not fn(name or "") \
                else opt._wd
            if opt._lr_ratio is not None:
                try:
                    lr_scale[i] = float(opt._lr_ratio(p))
                except Exception:
                    return None
        else:
            c = _classify_reg(preg if preg is not None
                              else opt._regularization_coeff)
            if c is None:
                return None
            l2[i], l1[i] = c
    return {"kind": kind, "l2": l2, "l1": l1, "wd": wd,
            "lr_scale": lr_scale}


# ---------------------------------------------------------------------------
# Flat math (the plain version of the kernel runs it tensor by tensor)
# ---------------------------------------------------------------------------

def fused_bucket_update(kind, flat_p, flat_g, state, lr, coeffs, hyper):
    """One parameter's update on flat 1-D tensors in the compute dtype
    (f32 for multi-precision, else the parameter's), with the same ops as
    the per-parameter ``_fn_apply``: the penalties folded into the
    gradient, then ``_sgd_math`` / ``_momentum_math`` / ``_adam_math``.
    ``coeffs`` holds this parameter's l2, l1, wd and lr_scale; ``hyper``
    the optimizer's beta1, beta2, epsilon, momentum and nesterov (the
    reference passes the optimizer). Returns (new_flat_p, new_state)."""
    from .optimizer import _adam_math, _momentum_math, _sgd_math
    l2, l1 = coeffs["l2"], coeffs["l1"]
    if l2:
        flat_g = flat_g + (l2 * flat_p).to(flat_g.dtype)
    if l1:
        flat_g = flat_g + (l1 * torch.sign(flat_p)).to(flat_g.dtype)
    lr_eff = lr if coeffs["lr_scale"] == 1.0 else lr * coeffs["lr_scale"]
    if kind == "sgd":
        return _sgd_math(flat_p, flat_g, lr_eff), {}
    if kind == "momentum":
        p2, v2 = _momentum_math(flat_p, flat_g, state["velocity"], lr_eff,
                                hyper["momentum"], hyper["nesterov"])
        return p2, {"velocity": v2}
    p2, m2, v2, t2 = _adam_math(
        flat_p, flat_g, state["moment1"], state["moment2"], state["step"],
        lr_eff, hyper["beta1"], hyper["beta2"], hyper["epsilon"],
        coeffs["wd"] if kind == "adamw" else 0.0)
    return p2, {"moment1": m2, "moment2": v2, "step": t2}


def _state_names(kind) -> Tuple[str, ...]:
    if kind == "sgd":
        return ()
    if kind == "momentum":
        return ("velocity",)
    return ("moment1", "moment2", "step")


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def _clip_spec(clip):
    from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
    if clip is None:
        return None
    if isinstance(clip, ClipGradByGlobalNorm):
        return ("global_norm", clip.clip_norm)
    if isinstance(clip, ClipGradByNorm):
        return ("norm", clip.clip_norm)
    return ("value", clip.min, clip.max)


class FusedPlan:
    """Signature-cached fused step over one list of parameters: their
    ``UpdateTable`` (state created where missing, coefficients from
    ``bucket_coeffs``), run once per step."""

    def __init__(self, opt, params, grads, names, sig):
        self.sig = sig
        self.kind = _kind_of(opt)
        coeffs = bucket_coeffs(opt, params, names)
        states = [opt._state_of(p) for p in params]
        hyper = {"beta1": getattr(opt, "beta1", 0.0),
                 "beta2": getattr(opt, "beta2", 0.0),
                 "epsilon": getattr(opt, "epsilon", 0.0),
                 "momentum": getattr(opt, "_momentum", 0.0),
                 "nesterov": getattr(opt, "_use_nesterov", False)}
        self.table = fk.UpdateTable(self.kind, params, states, coeffs,
                                    [g.dtype for g in grads], hyper,
                                    _clip_spec(opt._grad_clip))
        self.n_calls = 0

    def run(self, grads, lr, bad=None):
        """One step from ``grads`` (unclipped) at the f32 device scalar
        ``lr``; with ``bad`` set, every buffer keeps its value."""
        grads = [g.contiguous() for g in grads]
        scales = None
        if self.table.clip_mode == fk.CLIP_SCALE:
            scales = fk.grad_sq_norm(self.table, grads)[1]
        fk.fused_update(self.table, grads, lr, scales, bad)
        self.n_calls += 1


def _plan_signature(opt, params, grads):
    clip = opt._grad_clip
    return (id(type(opt)), opt._state_gen,
            (type(clip).__name__, getattr(clip, "clip_norm", None),
             getattr(clip, "max", None), getattr(clip, "min", None)),
            tuple((id(p), p.data_ptr(), tuple(p.shape), p.dtype, g.dtype)
                  for p, g in zip(params, grads)))


def steps_consistent(opt, params) -> bool:
    """True when the per-parameter 'step' accumulators (if any) agree, so
    one step count serves them all. Disagreement (partial restore, a
    parameter added mid-training) must take the per-parameter path:
    restarting Adam's bias correction would spike the effective lr. One
    host sync, at plan build only."""
    steps = [st["step"] for p in params
             if "step" in (st := opt._states.get(id(p), {}))]
    return len(steps) == 0 or torch.stack(steps).unique().numel() == 1


def fused_plan(opt, params, grads, names=None, cached=None,
               honour_need_clip=True) -> Optional[FusedPlan]:
    """``cached`` when its signature still matches, else a new plan for
    ``params`` and their ``grads``, or None when the configuration is not
    fusible. ``names`` are what ``apply_decay_param_fun`` sees (default:
    the eager path's ``param<i>``); ``honour_need_clip=False`` is
    ``TrainStep``'s clip, which ignores ``need_clip``."""
    if _kind_of(opt) is None:
        return None
    # cache check first: the eligibility walk below calls the user's
    # callables and syncs with the device, off the per-step path
    sig = _plan_signature(opt, params, grads)
    if cached is not None and cached.sig == sig:
        return cached
    from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                           ClipGradByValue)
    clip = opt._grad_clip
    if clip is not None and not isinstance(
            clip, (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)):
        return None
    if honour_need_clip and clip is not None and not all(
            getattr(p, "need_clip", True) for p in params):
        return None  # per-parameter need_clip opt-out: eager fallback
    if len({p.device for p in params}) != 1:
        return None
    names = opt._names_of(params) if names is None else names
    if bucket_coeffs(opt, params, names) is None:
        return None
    if not steps_consistent(opt, params):
        return None
    return FusedPlan(opt, params, grads, names, sig)


def try_fused_step(opt) -> bool:
    """Run one fused eager step. Returns False when the optimizer or
    parameter configuration needs the per-parameter path (the caller
    runs it)."""
    if not flag_value("fused_optimizer"):
        return False
    pg = [(p, p.grad) for p in opt._parameter_list
          if p.requires_grad and p.grad is not None]
    if not pg:
        return True  # nothing to update; parity with the eager loop
    params = [p for p, _ in pg]
    grads = [g for _, g in pg]
    plan = fused_plan(opt, params, grads,
                      cached=opt.__dict__.get("_fused_plan"))
    if plan is None:
        return False
    opt._fused_plan = plan
    plan.run(grads, opt._lr_operand(params[0].device))
    _count_dispatch(1, "fused")
    return True
