"""Rotary position embedding (counterpart of ``paddle_tpu/kernels/rope.py``).

Plain PyTorch: the reference has no Pallas kernel here either.
"""
from __future__ import annotations

import torch


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_emb(q, k, cos, sin, position_ids=None, use_neox=True):
    """q, k: [B, S, H, D]; cos/sin: [S, D], [B, S, D] (gathered per batch
    row, e.g. left-padded prompts) or [1, S, 1, D]. The trig tables are
    applied in the activation dtype."""
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    elif cos.dim() == 3:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    if position_ids is not None:
        cos = cos[0, :, 0][position_ids][:, :, None, :]
        sin = sin[0, :, 0][position_ids][:, :, None, :]
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    if use_neox:
        return (q * cos + _rotate_half(q) * sin,
                k * cos + _rotate_half(k) * sin)

    def rot(x):  # GPT-J interleaved style
        return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(
            x.shape)
    return q * cos + rot(q) * sin, k * cos + rot(k) * sin


def rope_freqs(head_dim, max_seq_len, base=10000.0, dtype=torch.float32,
               device=None):
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)
