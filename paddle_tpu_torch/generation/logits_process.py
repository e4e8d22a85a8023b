"""Logits processors for generation (counterpart of
``paddle_tpu/generation/logits_process.py``): plain tensor functions on
[B, V] logits. The top-k / top-p filters are the batched-operand ones of
``generation.sampling``, so eager and serve-loop filtering cannot drift
apart.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def apply_temperature(logits, temperature):
    t = torch.clamp(torch.as_tensor(temperature, dtype=logits.dtype,
                                    device=logits.device), min=1e-6)
    return logits / t


def top_k_filter(logits, k: int):
    """Keep the top-k logits per row, mask the rest (``k <= 0`` or ``k >=
    vocab`` keeps all)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    from .sampling import topk_mask
    return topk_mask(logits, k)


def top_p_filter(logits, p):
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution with cumulative probability >= p (the argmax always
    survives)."""
    from .sampling import topp_mask
    return topp_mask(logits, p)


def repetition_penalty(logits, token_counts, penalty):
    """Divide (positive) / multiply (negative) the logits of seen tokens;
    ``token_counts`` [B, V] occurrences of each token so far."""
    seen = torch.as_tensor(token_counts, device=logits.device) > 0
    # a fill on the device, not a copy from the host: the static route
    # runs inside a CUDA graph capture
    pen = torch.full((), float(penalty), dtype=logits.dtype,
                     device=logits.device)
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen, penalized, logits)


def min_length_mask(logits, cur_len, min_length: int, eos_token_id):
    """Forbid EOS before ``min_length`` tokens were generated."""
    if eos_token_id is None or min_length <= 0:
        return logits
    if cur_len >= min_length:
        return logits
    blocked = logits.clone()
    blocked[..., eos_token_id] = _NEG_INF
    return blocked
