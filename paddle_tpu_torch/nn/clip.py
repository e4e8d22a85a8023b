"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py`` and of
``paddle_tpu/jit/bridge.py`` ``_clip_grads_functional``).

Each class clips a list of gradient tensors (``clip_grads``, what
``TrainStep`` calls) or, called on ``[(param, grad), ...]`` pairs, the
pairs an optimizer's eager ``step`` collects. Nothing syncs with the
host: the scale factors stay on the device.

``need_clip``: as in the reference, the eager form leaves the gradient
of a parameter whose ``need_clip`` attribute is False as it is, and out
of the global norm (``paddle_tpu/nn/clip.py``); ``clip_grads``, the
``TrainStep`` form, clips every gradient, as the reference's
``_clip_grads_functional`` does.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        out = list(params_grads)
        idx = [i for i, (p, g) in enumerate(out)
               if g is not None and getattr(p, "need_clip", True)]
        for i, g in zip(idx, self.clip_grads([out[i][1] for i in idx])):
            out[i] = (out[i][0], g)
        return out

    def clip_grads(self, grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def clip_grads(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to at most ``clip_norm``, its norm taken in
    its own dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_grads(self, grads):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(g * g))
            out.append(g * torch.where(n > self.clip_norm,
                                       self.clip_norm / n, 1.0))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by ``clip_norm / max(norm, 1e-12)`` when their
    global norm exceeds ``clip_norm``; the norm is summed in f32 and the
    factor cast to each gradient's dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads):
        total = None
        for g in grads:
            sq = torch.sum(torch.square(g.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)

    def clip_grads(self, grads):
        if not grads:
            return grads
        gn = self.global_norm(grads)
        c = self.clip_norm
        scale = torch.where(gn > c, c / torch.clamp(gn, min=1e-12), 1.0)
        return [g * scale.to(g.dtype) for g in grads]
