"""Counterpart of ``paddle_tpu/models`` (Llama, GPT, BERT and ERNIE so
far)."""
from .bert import (BertConfig, BertEmbeddings, BertForSequenceClassification,
                   BertModel, BertPooler)
from .ernie import (ErnieConfig, ErnieEmbeddings,
                    ErnieForSequenceClassification, ErnieModel)
from .gpt import GPTBlock, GPTConfig, GPTForCausalLM, GPTModel
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, LlamaRMSNorm)

__all__ = ["BertConfig", "BertEmbeddings", "BertForSequenceClassification",
           "BertModel", "BertPooler", "ErnieConfig", "ErnieEmbeddings",
           "ErnieForSequenceClassification", "ErnieModel", "GPTBlock",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "LlamaAttention",
           "LlamaConfig", "LlamaDecoderLayer", "LlamaForCausalLM", "LlamaMLP",
           "LlamaModel", "LlamaPretrainingCriterion", "LlamaRMSNorm"]
