"""Layers of ``paddle_tpu/nn/layers_common.py`` as ``torch.nn.Module``s:
``Linear``, ``LayerNorm``, ``Embedding``, ``Dropout`` and ``LayerList``
(what the BERT/ERNIE path uses).

Parameter names are the reference's (``weight``, ``bias``), so
``convert.load_reference_state_dict`` moves weights across by name.
``Linear`` is a ``torch.nn.Linear``: it stores its weight as [out, in]
where Paddle stores [in, out], and ``convert`` transposes it. Default
initialisation follows the reference: Xavier-uniform linear weights and
zero biases, N(0, 1) embeddings (zero at ``padding_idx``), LayerNorm
weight one and bias zero, drawn from torch's default generators (see
``framework.random.seed``).
"""
from __future__ import annotations

import numbers

import torch
from torch import nn

from . import functional as PF


class Linear(nn.Linear):
    """``y = x W + b`` with a bias, as the reference's default."""

    def __init__(self, in_features, out_features, device=None, dtype=None):
        super().__init__(in_features, out_features, device=device,
                         dtype=dtype)

    def reset_parameters(self):
        nn.init.xavier_uniform_(self.weight)
        nn.init.zeros_(self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes through
    ``nn.functional.layer_norm`` (the LayerNorm kernel)."""

    def __init__(self, normalized_shape, epsilon=1e-05, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, numbers.Integral):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self._normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self._normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return PF.layer_norm(x, self._normalized_shape, self.weight,
                             self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class Embedding(nn.Module):
    """Lookup table [num_embeddings, embedding_dim]; ``std`` is the
    initial N(0, std) draw (the reference's ``weight_attr=Normal(0,
    std)``; 1 by default)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 std=1.0, device=None, dtype=None):
        super().__init__()
        self._padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, std)
            if padding_idx is not None:
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return PF.embedding(x, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return PF.dropout(x, self.p, axis=self.axis, training=self.training,
                          mode=self.mode)


class LayerList(nn.ModuleList):
    """The reference's ``LayerList``: sublayers registered as "0", "1",
    ... (so ``layers.3.linear1.weight`` names match)."""
