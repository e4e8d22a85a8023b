"""Counterpart of ``paddle_tpu/nn/functional.py`` (only what the Llama
serving and pretraining paths use)."""
import torch

from ..kernels.attention import flash_attention_bshd


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` on the
    [B, S, H, D] (flash) layout, through the flash-attention kernels."""
    return flash_attention_bshd(query, key, value, attn_mask=attn_mask,
                                dropout_p=dropout_p, is_causal=is_causal,
                                training=training)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """``paddle.nn.functional.cross_entropy`` with hard integer labels
    over the last axis. The log-softmax runs in the logits' dtype, as the
    reference's ``jax.nn.log_softmax(logits)`` does; rows labelled
    ``ignore_index`` give 0 and leave the mean's denominator; a label
    outside [0, C) gives NaN (the upstream kernel refuses it). Soft
    labels, class weights, label smoothing and ``use_softmax=False`` are
    not ported."""
    if soft_label or weight is not None or label_smoothing or \
            not use_softmax or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy: only hard labels over the last axis, without "
            "weight or label smoothing, are ported")
    if label.dtype.is_floating_point:
        raise TypeError("cross_entropy: hard labels must be integers")
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    n = input.shape[-1]
    logp = torch.log_softmax(input, dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid & (label >= 0) & (label < n), label, 0)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    oob = valid & ((label < 0) | (label >= n))
    nll = torch.where(oob, float("nan"), nll)
    loss = torch.where(valid, nll, 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    # mean over the non-ignored rows; the all-ignored case gives 0
    den = valid.to(loss.dtype).sum()
    return loss.sum() / torch.clamp(den, min=1e-12)
