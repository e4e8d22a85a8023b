"""Weight transfer to and from the reference package's state dict.

``load_reference_state_dict(model, {name: np.ndarray})`` copies a
``paddle_tpu`` model's weights (exported as numpy arrays, e.g.
``{k: t.numpy() for k, t in ref.state_dict().items()}``) into the port's
model of the same config, so that both packages compute the same thing.
Paddle's ``Linear`` stores its weight as [in, out] and ``nn.Linear`` as
[out, in], so those are transposed; embeddings are [V, D] in both.
Non-persistable buffers (the RoPE tables) are recomputed by the port's
model, never copied. ``export_reference_state_dict`` is the inverse:
the port's weights in the reference's names and [in, out] layout.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _linear_weights(model: nn.Module) -> set:
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, nn.Linear)}


def load_reference_state_dict(model: nn.Module, state: dict) -> nn.Module:
    linear_weights = _linear_weights(model)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"reference state dict does not match the model: "
                       f"missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(state[name])
            if name in linear_weights:
                a = a.T
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {a.shape} does "
                                 f"not fit parameter shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, copy=True)))
    return model


def export_reference_state_dict(model: nn.Module) -> dict:
    """``{name: np.ndarray}`` of every parameter in the reference's layout
    (linear weights transposed to [in, out]); bf16 weights come out as
    float32, which holds them exactly (numpy has no bfloat16)."""
    linear_weights = _linear_weights(model)
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        out[name] = np.ascontiguousarray(a.T if name in linear_weights
                                         else a)
    return out
