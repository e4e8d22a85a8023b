"""PyTorch/CUDA port of paddle_tpu, for one NVIDIA Hopper GPU.

The JAX package ``paddle_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Plain tensor code is PyTorch;
every Pallas kernel of the ported path is a hand-written Hopper kernel
(CUDA C++ under ``csrc/``, or Triton), with a plain PyTorch version of
the same function beside it that CPU tensors take.

Ported so far: Llama serving, greedy and sampled — ``models.llama``,
``generation.kv_cache``, ``generation.sampling`` and
``inference.ContinuousBatchingPredictor`` over the RMSNorm,
flash-attention forward, paged/ragged decode and sampling-draw kernels,
and the eager ``generate()`` of ``generation.GenerationMixin`` — Llama
pretraining — ``trainer.Trainer`` over
``jit.TrainStep``, ``optimizer.AdamW`` and ``distributed.
VerifiedCheckpointer``, with the flash-attention backward kernels — and
BERT / ERNIE sequence-classification fine-tuning
(``examples.bert_finetune``) over the LayerNorm kernel and the flash
kernels' counter-hash attention dropout — and the fused multi-tensor
optimizer step (``optimizer.fused``: SGD, Momentum, Adam, AdamW under
the eager ``step()`` and ``TrainStep``) over the ``grad_sq_norm`` and
``fused_update`` kernels — and float16 training: ``amp`` (``auto_cast``
O1 / O2, ``decorate``, ``GradScaler`` in the eager loop and inside
``jit.TrainStep``) over the f16 instances of the flash kernels, with
activation recompute (``distributed.fleet.recompute``,
``LlamaConfig.use_recompute``).

Runtime telemetry (metrics, spans, the flight recorder, exporters) is
``observability``, the reference's package.

Parameters are drawn as the reference draws them: ``ParamAttr`` and the
initializers of ``nn.initializer`` (``Normal``, ``XavierUniform``,
``Constant``, ... and ``set_global_initializer``), given as
``weight_attr`` / ``bias_attr`` to ``nn.Linear``, ``nn.LayerNorm``,
``nn.Embedding``, ``nn.MultiHeadAttention`` and
``nn.TransformerEncoderLayer`` in the reference's positions (``False``:
no parameter), each initializer drawing from an explicit
``torch.Generator`` or torch's default one.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
import torch

# f32 parity with the reference, which forces
# jax_default_matmul_precision="highest": no TF32 in f32 matmuls or
# convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .framework import resolve_device  # noqa: E402
from . import observability  # noqa: E402,F401
from .nn.initializer import ParamAttr  # noqa: E402

__all__ = ["ParamAttr", "resolve_device", "observability"]
