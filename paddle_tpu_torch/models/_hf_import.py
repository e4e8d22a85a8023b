"""Shared plumbing for HuggingFace checkpoint importers (the port's own
copy of ``paddle_tpu/models/_hf_import.py``'s ``hf_tensor_to_numpy`` and
``validate_keys``)."""
from __future__ import annotations

import numpy as np


def hf_tensor_to_numpy(p):
    """torch tensors may be CUDA-resident or bf16 — both reject
    .numpy(); plain arrays pass through."""
    if hasattr(p, "detach"):
        p = p.detach().cpu()
        if str(p.dtype) == "torch.bfloat16":
            p = p.float()
        return p.numpy()
    return np.asarray(p)


def validate_keys(model, sd, what):
    own = set(model.state_dict())
    unknown = [k for k in sd if k not in own]
    missing = [k for k in own if k not in sd]
    if unknown or missing:
        raise ValueError(f"{what} state_dict mismatch: "
                         f"unknown={unknown[:5]} missing={missing[:5]}")
