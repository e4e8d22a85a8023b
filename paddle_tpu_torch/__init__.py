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
``fused_update`` kernels.

Runtime telemetry (metrics, spans, the flight recorder, exporters) is
``observability``, the reference's package.

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

__all__ = ["resolve_device", "observability"]
