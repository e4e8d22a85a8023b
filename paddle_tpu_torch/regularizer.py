"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

- An optimizer's ``weight_decay`` may be a number (an L2 coefficient) or
  one of these instances.
- A ``regularizer`` attribute set on a parameter takes priority over the
  optimizer's for that parameter.
- Coupled optimizers fold the penalty into the gradient (``g + coeff * p``
  for L2, ``g + coeff * sign(p)`` for L1). AdamW keeps its decoupled
  decay, and folds a parameter's own regularizer in as well.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    """Base class; subclasses implement ``__call__(param, grad) -> grad``."""

    def __call__(self, param, grad):
        raise NotImplementedError("subclass L1Decay/L2Decay and implement "
                                  "__call__(param, grad)")


class L2Decay(WeightDecayRegularizer):
    """``grad + coeff * param``."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param, grad):
        return grad + self._coeff * param

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay(WeightDecayRegularizer):
    """``grad + coeff * sign(param)``."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __call__(self, param, grad):
        return grad + self._coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay({self._coeff})"
