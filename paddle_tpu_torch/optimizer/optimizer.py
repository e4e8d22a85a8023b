"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``:
``Optimizer``, ``Adam``, ``AdamW``, the functional init/apply that
``TrainStep`` runs, and the multi-precision master weights).

The update math is the reference's ``_adam_math``, not
``torch.optim.AdamW``'s: the bias-corrected moments are formed first and
``eps`` is added to ``sqrt(vhat)``, ``upd = lr*mhat/(sqrt(vhat)+eps)``,
and AdamW's decoupled decay ``lr*wd*p`` is added to that update, with a
per-parameter int32 step. The learning rate enters as an f32 device
scalar, as the reference's ``_lr_operand``. A bf16 (or f16) parameter
carries an f32 ``master_weight`` and f32 moments; the update runs on the
master and the parameter is the master cast down (``_mp_active``).
"""
from __future__ import annotations

import torch

from .lr import LRScheduler


class Optimizer:
    """Base optimizer over ``parameters`` (tensors). In ``state_dict`` and
    the eager ``step`` a parameter is called ``param<i>`` by position (the
    reference's key for a parameter without a name); ``TrainStep`` passes
    the model's parameter names instead."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
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
        else:
            raise NotImplementedError(
                "only a float weight_decay coefficient is ported")
        self._states = {}         # id(param) -> {accumulator: tensor}
        self._lr_tensors = {}     # device -> f32 scalar operand

    # ------------------------------------------------------------ LR API --
    def get_lr(self):
        lr = self._learning_rate
        return lr() if isinstance(lr, LRScheduler) else float(lr)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

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

    def _decayed_grad(self, p, g):
        """Coupled L2 decay folded into the gradient (Adam, SGD...)."""
        c = self._regularization_coeff
        return g + c * p if c else g

    def _fn_apply(self, p, g, s, lr, name, param):
        raise NotImplementedError

    @torch.no_grad()
    def apply_gradients(self, params, grads, lr, names, bad=None):
        """One update of ``params`` (in place) from ``grads`` at the f32
        device scalar ``lr``. With ``bad`` (a device bool scalar), every
        parameter, master weight and moment keeps its pre-step value where
        ``bad`` is true: a select on the device, no host sync."""
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
            self._states[id(p)] = s2

    def step(self):
        """Eager update from each parameter's ``.grad`` (clipped first)."""
        pg = [(p, p.grad) for p in self._parameter_list if p.requires_grad]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        if not pg:
            return
        names = {id(p): n for p, n in zip(self._parameter_list,
                                          self._param_names)}
        self.apply_gradients([p for p, _ in pg], [g for _, g in pg],
                             self._lr_operand(pg[0][0].device),
                             [names[id(p)] for p, _ in pg])

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # ----------------------------------------------------------- state io --
    def state_dict(self):
        """``{"<param name>_<accumulator>": tensor}`` (plus the scheduler's
        state under ``LR_Scheduler``)."""
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


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self._multi_precision = multi_precision

    def _fn_init(self, a):
        return {"moment1": torch.zeros_like(a), "moment2": torch.zeros_like(a),
                "step": torch.zeros((), dtype=torch.int32, device=a.device)}

    def _fn_apply(self, p, g, s, lr, name, param):
        return self._adam(p, self._decayed_grad(p, g), s, lr, 0.0)

    def _adam(self, p, g, s, lr, wd):
        p2, m2, v2, t2 = _adam_math(p, g, s["moment1"], s["moment2"],
                                    s["step"], lr, self.beta1, self.beta2,
                                    self.epsilon, wd)
        return p2, {"moment1": m2, "moment2": v2, "step": t2}


class AdamW(Adam):
    """Adam with decoupled weight decay ``wd`` (0 for the parameters whose
    name ``apply_decay_param_fun`` rejects); ``lr_ratio(param)`` scales
    the learning rate per parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision)
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
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(param)
        return self._adam(p, g, s, lr, wd)
