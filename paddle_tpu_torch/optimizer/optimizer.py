"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``:
``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, the
functional init/apply that ``TrainStep`` runs, and the multi-precision
master weights).

The update math is the reference's ``_adam_math``, not
``torch.optim.AdamW``'s: the bias-corrected moments are formed first and
``eps`` is added to ``sqrt(vhat)``, ``upd = lr*mhat/(sqrt(vhat)+eps)``,
and AdamW's decoupled decay ``lr*wd*p`` is added to that update, with a
per-parameter int32 step. The learning rate enters as an f32 device
scalar, as the reference's ``_lr_operand``. A bf16 (or f16) parameter
carries an f32 ``master_weight`` and f32 moments; the update runs on the
master and the parameter is the master cast down (``_mp_active``).

``step()`` first tries the fused step (``optimizer/fused.py``: one
multi-tensor kernel launch per step on the card). Where the reference
would not fuse, it runs the per-parameter ``apply_gradients``, which
replaces each state tensor with a new one; the fused step updates the
same per-parameter tensors in place.
"""
from __future__ import annotations

import torch

from ..regularizer import WeightDecayRegularizer
from .lr import LRScheduler


class Optimizer:
    """Base optimizer over ``parameters`` (tensors). In ``state_dict`` and
    the eager ``step`` a parameter is called ``param<i>`` by position (the
    reference's key for a parameter without a name); ``TrainStep`` passes
    the model's parameter names instead. ``name``, and ``Adam`` /
    ``AdamW``'s ``lazy_mode`` and ``use_multi_tensor``, are taken in the
    reference's places and, as there, not read."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters is required")
        self._parameter_list = list(parameters)
        self._param_names = [f"param{i}"
                             for i in range(len(self._parameter_list))]
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (int, float)):
            self._regularization_coeff = float(weight_decay)
        elif weight_decay is None:
            self._regularization_coeff = 0.0
        elif isinstance(weight_decay, WeightDecayRegularizer):
            self._regularization_coeff = weight_decay
        else:
            raise NotImplementedError(
                "weight_decay: a number or an L1Decay / L2Decay is ported, "
                f"not {type(weight_decay).__name__}")
        self._states = {}         # id(param) -> {accumulator: tensor}
        # bumped whenever state tensors are replaced rather than updated
        # in place, so a fused plan (which holds their addresses) rebuilds
        self._state_gen = 0
        self._lr_tensors = {}     # device -> f32 scalar operand

    # ------------------------------------------------------------ LR API --
    def get_lr(self):
        lr = self._learning_rate
        return lr() if isinstance(lr, LRScheduler) else float(lr)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        """The ``LRScheduler`` behind the learning rate, or None (what
        ``hapi``'s ``LRScheduler`` callback steps)."""
        lr = self._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    def _lr_operand(self, device):
        """The current lr as an f32 scalar on ``device``, refilled in place
        each step (a fill, not a host-to-device copy that would sync)."""
        t = self._lr_tensors.get(device)
        if t is None:
            t = self._lr_tensors[device] = torch.empty(
                (), dtype=torch.float32, device=device)
        return t.fill_(self.get_lr())

    # ------------------------------------------------------------- state --
    def _mp_active(self, p) -> bool:
        """f32 master weights and moments for a bf16/f16 parameter unless
        ``multi_precision=False`` (reference: on by default)."""
        mp = getattr(self, "_multi_precision", None)
        return (True if mp is None else bool(mp)) and p.dtype in (
            torch.bfloat16, torch.float16)

    def _state_of(self, p):
        """The parameter's state, created on first use."""
        st = self._states.get(id(p))
        if st is None:
            with torch.no_grad():
                if self._mp_active(p):
                    master = p.detach().float().clone()
                    st = self._fn_init(master)
                    st["master_weight"] = master
                else:
                    st = self._fn_init(p.detach())
            self._states[id(p)] = st
        return st

    def _decayed_grad(self, p, g, param=None):
        """The weight-decay penalty folded into the gradient (Adam, SGD,
        Momentum). ``p`` is the value the update runs on (the master
        weight under multi-precision); ``param``'s own ``regularizer``
        attribute takes priority over the optimizer's ``weight_decay``."""
        reg = getattr(param, "regularizer", None)
        if reg is None:
            reg = self._regularization_coeff
        if callable(reg):
            return reg(p, g)
        return g + reg * p if reg else g

    def _fn_apply(self, p, g, s, lr, name, param):
        raise NotImplementedError

    @torch.no_grad()
    def apply_gradients(self, params, grads, lr, names, bad=None,
                        in_place=False):
        """The per-parameter update of ``params`` (in place) from
        ``grads`` at the f32 device scalar ``lr``. With ``bad`` (a device
        bool scalar), every parameter, master weight and moment keeps its
        pre-step value where ``bad`` is true: a select on the device, no
        host sync. The new state replaces the old tensors, or, with
        ``in_place`` (``jit.TrainStep``, whose CUDA graph reads the state
        by address), is copied into them."""
        if not in_place:
            self._state_gen += 1
        for p, g, name in zip(params, grads, names):
            if g is None:
                continue
            s = self._state_of(p)
            if "master_weight" in s:
                inner = {k: v for k, v in s.items() if k != "master_weight"}
                mw2, s2 = self._fn_apply(s["master_weight"], g.float(),
                                         inner, lr, name, p)
                s2["master_weight"] = mw2
                p2 = mw2.to(p.dtype)
            else:
                p2, s2 = self._fn_apply(p, g.to(p.dtype), s, lr, name, p)
            if bad is not None:
                p2 = torch.where(bad, p, p2)
                s2 = {k: torch.where(bad, s[k], v) for k, v in s2.items()}
            p.copy_(p2)
            if in_place:
                for k, v in s2.items():
                    s[k].copy_(v)
            else:
                self._states[id(p)] = s2

    @torch.no_grad()
    def step(self):
        """Eager update from each parameter's ``.grad`` (clipped first):
        the fused step where it applies, else the per-parameter one."""
        from .fused import _count_dispatch, try_fused_step
        if try_fused_step(self):
            return
        # back on the per-parameter path: retire the plan (it keeps no
        # state of its own to flush; apply_gradients invalidates it too)
        self._fused_plan = None
        pg = [(p, p.grad) for p in self._parameter_list if p.requires_grad]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        pg = [(p, g) for p, g in pg if g is not None]
        if not pg:
            return
        names = self._names_of([p for p, _ in pg])
        self.apply_gradients([p for p, _ in pg], [g for _, g in pg],
                             self._lr_operand(pg[0][0].device), names)
        _count_dispatch(len(pg), "per_param")

    def _names_of(self, params):
        """The eager path's names (``param<i>``) of ``params``."""
        names = {id(p): n for p, n in zip(self._parameter_list,
                                          self._param_names)}
        return [names[id(p)] for p in params]

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # ----------------------------------------------------------- state io --
    def state_dict(self):
        """``{"<param name>_<accumulator>": tensor}`` (plus the scheduler's
        state under ``LR_Scheduler``). The tensors are the live state, as
        in ``torch.optim``: the fused step updates them in place."""
        out = {}
        for name, p in zip(self._param_names, self._parameter_list):
            for k, v in self._states.get(id(p), {}).items():
                out[f"{name}_{k}"] = v
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict):
        """Restore from ``state_dict()`` output; an entry creates its
        parameter's state when no step has run yet. Keys split at the
        rightmost underscore that leaves a known parameter name."""
        self._state_gen += 1
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        by_name = dict(zip(self._param_names, self._parameter_list))
        for key, v in state_dict.items():
            if key == "LR_Scheduler":
                continue
            cut = len(key)
            while (cut := key.rfind("_", 0, cut)) >= 0:
                p = by_name.get(key[:cut])
                if p is not None:
                    self._states.setdefault(id(p), {})[key[cut + 1:]] = \
                        torch.as_tensor(v).to(p.device).clone()
                    break


def _sgd_math(p, g, lr):
    """The reference's ``_sgd_math``."""
    return p - lr * g


def _momentum_math(p, g, v, lr, mu, nesterov):
    """The reference's ``_momentum_math``: returns (p', v')."""
    v2 = mu * v + g
    if nesterov:
        p2 = p - lr * (g + mu * v2)
    else:
        p2 = p - lr * v2
    return p2, v2


def _adam_math(p, g, m, v, t, lr, b1, b2, eps, wd):
    """The reference's ``_adam_math``: returns (p', m', v', t'), computed
    in the moments' dtype (f32 for master weights)."""
    t2 = t + 1
    gf = g.to(m.dtype)
    m2 = b1 * m + (1 - b1) * gf
    v2 = b2 * v + (1 - b2) * (gf * gf)
    tf = t2.to(m.dtype)
    mhat = m2 / (1 - torch.pow(b1, tf))
    vhat = v2 / (1 - torch.pow(b2, tf))
    upd = lr * mhat / (torch.sqrt(vhat) + eps)
    if wd:
        upd = upd + lr * wd * p.to(m.dtype)
    p2 = (p.to(m.dtype) - upd).to(p.dtype)
    return p2, m2, v2, t2


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._multi_precision = multi_precision

    def _fn_init(self, a):
        return {}

    def _fn_apply(self, p, g, s, lr, name, param):
        return _sgd_math(p, self._decayed_grad(p, g, param), lr), {}


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._multi_precision = multi_precision

    def _fn_init(self, a):
        return {"velocity": torch.zeros_like(a)}

    def _fn_apply(self, p, g, s, lr, name, param):
        p2, v2 = _momentum_math(p, self._decayed_grad(p, g, param),
                                s["velocity"], lr, self._momentum,
                                self._use_nesterov)
        return p2, {"velocity": v2}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=None,
                 use_multi_tensor=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self._multi_precision = multi_precision

    def _fn_init(self, a):
        return {"moment1": torch.zeros_like(a), "moment2": torch.zeros_like(a),
                "step": torch.zeros((), dtype=torch.int32, device=a.device)}

    def _fn_apply(self, p, g, s, lr, name, param):
        return self._adam(p, self._decayed_grad(p, g, param), s, lr, 0.0)

    def _adam(self, p, g, s, lr, wd):
        p2, m2, v2, t2 = _adam_math(p, g, s["moment1"], s["moment2"],
                                    s["step"], lr, self.beta1, self.beta2,
                                    self.epsilon, wd)
        return p2, {"moment1": m2, "moment2": v2, "step": t2}


class AdamW(Adam):
    """Adam with decoupled weight decay ``wd`` (0 for the parameters whose
    name ``apply_decay_param_fun`` rejects); ``lr_ratio(param)`` scales
    the learning rate per parameter. A parameter's own ``regularizer``
    is folded into its gradient besides."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        if isinstance(weight_decay, WeightDecayRegularizer):
            # as the reference (and upstream adamw.py): the decay is
            # decoupled, so its coefficient must be a number
            raise TypeError(
                "AdamW's weight_decay (coeff) must be a float, not "
                f"{type(weight_decay).__name__}; set a regularizer on the "
                "parameter instead")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "AdamW: only a float weight_decay coefficient is ported")
        self._wd = float(weight_decay or 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _fn_apply(self, p, g, s, lr, name, param):
        wd = self._wd
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name or ""):
            wd = 0.0
        if getattr(param, "regularizer", None) is not None:
            g = self._decayed_grad(p, g, param)
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(param)
        return self._adam(p, g, s, lr, wd)
