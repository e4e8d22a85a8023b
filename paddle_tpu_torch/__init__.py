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
``LlamaConfig.use_recompute``) — and ResNet training on one device:
``vision.models`` (the ResNet family over ``nn.Conv2D``,
``nn.BatchNorm2D`` and the pools), ``vision.datasets.FakeData``,
``io.DataLoader``, ``metric`` and ``Model.fit`` / ``evaluate`` over the
captured ``jit.TrainStep``.

Runtime telemetry (metrics, spans, the flight recorder, exporters) is
``observability``, the reference's package.

Every layer and model derives from ``nn.Layer``, the reference's base
class over ``torch.nn.Module``: ``state_dict`` / ``set_state_dict``
(loads in place and returns ``(missing, unexpected)``), ``sublayers``,
``parameters(include_sublayers=)``, the forward pre / post hooks,
``full_name``, ``astype`` / ``float16``, ``clear_gradients``. Code
written against the reference runs as it is:
``import paddle_tpu_torch as paddle``; ``paddle.seed(0)``;
``model.set_state_dict(paddle.load(path))``; ``paddle.to_tensor(x)``.

Parameters are drawn as the reference draws them: ``ParamAttr`` and the
initializers of ``nn.initializer`` (``Normal``, ``XavierUniform``,
``Constant``, ... and ``set_global_initializer``), given as
``weight_attr`` / ``bias_attr`` to ``nn.Linear``, ``nn.LayerNorm``,
``nn.Embedding``, ``nn.MultiHeadAttention`` and
``nn.TransformerEncoderLayer`` in the reference's positions (``False``:
no parameter), each initializer drawing from an explicit
``torch.Generator`` or torch's default one.

The top level holds the reference's names for what is ported: the
dtypes (``float32``, ``bfloat16``, ... torch's dtypes; ``bool``),
``set_default_dtype`` / ``get_default_dtype``, ``finfo`` / ``iinfo``;
``set_device`` / ``get_device``, ``CPUPlace``, ``CUDAPlace``,
``device_count``; ``seed``, ``get_rng_state`` / ``set_rng_state``;
``to_tensor`` and ``create_parameter``; ``no_grad``, ``enable_grad``,
``is_grad_enabled``, ``set_grad_enabled``; ``save`` / ``load``;
``ParamAttr``; ``in_dynamic_mode``; ``flops``, ``Model`` and
``summary`` (``hapi``); and the subpackages ``nn``, ``optimizer``,
``amp``, ``jit``, ``inference``, ``distributed``, ``incubate``,
``generation``, ``observability``, ``hapi``, ``io``, ``metric``,
``vision`` and ``callbacks`` (``hapi.callbacks``). The reference's
``Tensor`` methods, ``ops`` and the rest are not ported yet and have no
name here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or ``set_device("cpu")``).
"""
import torch

# f32 parity with the reference, which forces
# jax_default_matmul_precision="highest": no TF32 in f32 matmuls or
# convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .framework import resolve_device  # noqa: E402
from .framework.dtype import (  # noqa: E402
    bool_ as bool,  # noqa: A001  (paddle.bool)
    uint8, int8, int16, int32, int64, float16, bfloat16, float32, float64,
    complex64, complex128, float8_e4m3fn, float8_e5m2,
    set_default_dtype, get_default_dtype, finfo, iinfo)
from .framework.place import (CPUPlace, CUDAPlace, get_device,  # noqa: E402
                              set_device)
from .framework.random import get_rng_state, seed, set_rng_state  # noqa: E402
from .tensor import create_parameter, to_tensor  # noqa: E402
from .autograd import (enable_grad, is_grad_enabled, no_grad,  # noqa: E402
                       set_grad_enabled)
from .framework_io import load, save  # noqa: E402
from .nn.initializer import ParamAttr  # noqa: E402
from . import (amp, autograd, distributed, generation,  # noqa: E402
               hapi, incubate, inference, io, jit, metric, nn, observability,
               optimizer, vision)
from .hapi import Model, callbacks, flops, summary  # noqa: E402


def in_dynamic_mode():
    """Always True: the port runs eagerly (graphs are captured from eager
    runs, never traced from a static program)."""
    return True


def device_count():
    """The number of CUDA devices."""
    return torch.cuda.device_count()


__all__ = [
    "CPUPlace", "CUDAPlace", "Model", "ParamAttr", "amp", "autograd",
    "bfloat16", "bool", "callbacks", "complex128", "complex64",
    "create_parameter", "device_count", "distributed", "enable_grad",
    "finfo", "float16", "float32", "float64", "float8_e4m3fn",
    "float8_e5m2", "flops", "generation", "get_default_dtype", "hapi",
    "get_device", "get_rng_state", "iinfo", "in_dynamic_mode", "incubate",
    "inference", "int16", "int32", "int64", "int8", "io",
    "is_grad_enabled", "jit", "load", "metric", "nn", "no_grad",
    "observability", "optimizer", "resolve_device", "save", "seed",
    "set_default_dtype", "set_device", "set_grad_enabled", "set_rng_state",
    "summary", "to_tensor", "uint8", "vision"]
