"""Weight transfer to and from the reference package's state dict.

``load_reference_state_dict(model, {name: np.ndarray or tensor})`` copies a
``paddle_tpu`` model's weights (exported as numpy arrays, e.g.
``{k: t.numpy() for k, t in ref.state_dict().items()}``) into the port's
model of the same config, so that both packages compute the same thing.
Paddle's ``Linear`` stores its weight as [in, out] and ``nn.Linear`` as
[out, in], so those are transposed; embeddings are [V, D] in both.
Convolution weights are [out, in / groups, kh, kw] in both and are
not transposed; persistable buffers (a BatchNorm's ``_mean`` and
``_variance``) are copied like parameters. Non-persistable buffers (the
RoPE tables) are recomputed by the port's model, never copied. GPT's fused ``qkv`` projection is one linear (its
[in, 3 * hidden] weight transposed whole), and its LM head is ``wte``
itself: the state dict names it once, so it is written once.
``export_reference_state_dict`` is the inverse:
the port's weights in the reference's names and [in, out] layout. Both
cover the state dict: parameters and persistent buffers.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def linear_weights(model: nn.Module) -> set:
    """Names of the weights the two layouts transpose."""
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, nn.Linear)}


def load_reference_state_dict(model: nn.Module, state: dict) -> nn.Module:
    linear = linear_weights(model)
    params = model.state_dict(keep_vars=True)
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"reference state dict does not match the model: "
                       f"missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, p in params.items():
            a = state[name]
            t = a.detach() if isinstance(a, torch.Tensor) \
                else torch.from_numpy(np.array(a, copy=True))
            if name in linear:
                t = t.t()
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {tuple(t.shape)} "
                                 "does not fit parameter shape "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
    return model


def export_reference_state_dict(model: nn.Module, bf16_bits=False) -> dict:
    """``{name: np.ndarray}`` of the state dict in the reference's layout
    (linear weights transposed to [in, out]); bf16 weights come out as
    float32, which holds them exactly (numpy has no bfloat16), or with
    ``bf16_bits`` as their uint16 bits (the ``.pdiparams`` format)."""
    linear = linear_weights(model)
    out = {}
    for name, p in model.state_dict().items():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16) if bf16_bits else t.float()
        a = t.numpy()
        out[name] = np.ascontiguousarray(a.T if name in linear else a)
    return out
