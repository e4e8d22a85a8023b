"""Counterpart of ``paddle_tpu/models`` (Llama, BERT and ERNIE so far)."""
from .bert import (BertConfig, BertEmbeddings, BertForSequenceClassification,
                   BertModel, BertPooler)
from .ernie import (ErnieConfig, ErnieEmbeddings,
                    ErnieForSequenceClassification, ErnieModel)
from .llama import (LlamaAttention, LlamaConfig, LlamaDecoderLayer,
                    LlamaForCausalLM, LlamaMLP, LlamaModel,
                    LlamaPretrainingCriterion, LlamaRMSNorm)

__all__ = ["BertConfig", "BertEmbeddings", "BertForSequenceClassification",
           "BertModel", "BertPooler", "ErnieConfig", "ErnieEmbeddings",
           "ErnieForSequenceClassification", "ErnieModel",
           "LlamaAttention", "LlamaConfig", "LlamaDecoderLayer",
           "LlamaForCausalLM", "LlamaMLP", "LlamaModel",
           "LlamaPretrainingCriterion", "LlamaRMSNorm"]
