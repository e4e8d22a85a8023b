"""Counterpart of ``paddle_tpu/models`` (Llama so far)."""
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, LlamaRMSNorm)

__all__ = ["LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel",
           "LlamaPretrainingCriterion", "LlamaRMSNorm"]
