"""Counterpart of ``paddle_tpu/nn/functional.py`` (only what the Llama
serving path uses)."""
from ..kernels.attention import flash_attention_bshd


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` on the
    [B, S, H, D] (flash) layout, through the flash-attention kernel."""
    return flash_attention_bshd(query, key, value, attn_mask=attn_mask,
                                dropout_p=dropout_p, is_causal=is_causal,
                                training=training)
