"""Loss layers (counterpart of ``paddle_tpu/nn/losses.py``:
``CrossEntropyLoss`` and ``NLLLoss``)."""
from __future__ import annotations

from . import functional as PF
from .layer_base import Layer


class CrossEntropyLoss(Layer):
    """``nn.functional.cross_entropy`` as a layer, with every argument it
    takes."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
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


class NLLLoss(Layer):
    """``nn.functional.nll_loss`` as a layer."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return PF.nll_loss(input, label, self.weight, self.ignore_index,
                           self.reduction)
