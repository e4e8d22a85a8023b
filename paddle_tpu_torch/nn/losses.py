"""Loss layers (counterpart of ``paddle_tpu/nn/losses.py``)."""
from __future__ import annotations

from torch import nn

from . import functional as PF


class CrossEntropyLoss(nn.Module):
    """``nn.functional.cross_entropy`` as a layer: hard integer labels
    over the last axis (soft labels, class weights and label smoothing
    raise, as there)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return PF.cross_entropy(input, label, weight=self.weight,
                                ignore_index=self.ignore_index,
                                reduction=self.reduction,
                                soft_label=self.soft_label, axis=self.axis,
                                use_softmax=self.use_softmax,
                                label_smoothing=self.label_smoothing)
