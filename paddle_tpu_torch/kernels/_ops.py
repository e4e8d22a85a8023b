"""The ``paddle_tpu_torch`` operator namespace: the forward kernels that
``torch.export`` must see as single calls (``torch.library`` custom
ops, ``torch.ops.paddle_tpu_torch.<name>``). ``define_op`` registers one
op with three implementations: the plain version for CPU tensors, the
kernel wrapper for CUDA tensors (it launches and counts, or raises) and
a fake one that gives the outputs' shapes and dtypes to a trace. A
loaded ``torch.export`` program calls the ops by name, so importing the
kernel modules registers them.
"""
from __future__ import annotations

import torch

_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")


def define_op(schema: str, cpu, cuda, fake) -> None:
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"paddle_tpu_torch::{name}", fake, lib=_LIB)
