"""Counterpart of ``paddle_tpu/incubate/nn/functional.py`` (only what the
Llama serving path uses)."""
import torch
import torch.nn.functional as F


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with ``y`` None, ``x`` is split in half on its last
    axis. Plain tensor ops, as in the reference."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y
