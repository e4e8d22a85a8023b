"""``paddle.metric`` (counterpart of ``paddle_tpu/metric/__init__.py``):
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and the
functional ``accuracy``.

``Accuracy.compute`` ranks on the predictions' device (``torch.topk``;
the reference sorts on the host with ``np.argsort``: the two may order
exact ties differently); ``update`` and the other metrics accumulate
plain numbers on the host, each call reading its inputs back once.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]


def _host(x):
    """``x`` (a tensor, array or number) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``: ``compute(pred, label)``
    gives the [..., max k] hits (f32), ``update`` adds them up and returns
    this batch's accuracy, ``accumulate`` the running one (one number, or
    a list for several k)."""

    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = torch.as_tensor(pred)
        lab = torch.as_tensor(label, device=p.device)
        if lab.dim() == p.dim() and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        idx = torch.topk(p, self.maxk, dim=-1).indices
        return (idx == lab.unsqueeze(-1)).to(torch.float32)

    def update(self, correct, *args):
        c = _host(correct)
        accs = []
        n = int(np.prod(c.shape[:-1]))
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())
            self.total[i] += num
            self.count[i] += n
            accs.append(num / max(n, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision: a prediction above 0.5 is positive."""

    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        pos = (_host(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _host(labels).reshape(-1)
        self.tp += int(((pos == 1) & (lab == 1)).sum())
        self.fp += int(((pos == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall: a prediction above 0.5 is positive."""

    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        pos = (_host(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _host(labels).reshape(-1)
        self.tp += int(((pos == 1) & (lab == 1)).sum())
        self.fn += int(((pos == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` + 1 score buckets (a [N, 2]
    prediction's column 1 is the positive score), integrated by the
    trapezoid rule. ``curve`` is taken and, as in the reference, not
    read."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        if p.ndim == 2:
            p = p[:, 1]
        lab = _host(labels).reshape(-1)
        idx = np.minimum((p * self.num_thresholds).astype(np.int64),
                         self.num_thresholds)
        np.add.at(self._stat_pos, idx[lab != 0], 1)
        np.add.at(self._stat_neg, idx[lab == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` highest scores, as
    a [1] f32 tensor on ``input``'s device. ``correct`` and ``total`` are
    taken and, as in the reference, not written."""
    lab = label[..., 0] if (label.dim() == input.dim()
                            and label.shape[-1] == 1) else label
    idx = torch.topk(input, k, dim=-1).indices
    hit = (idx == lab.unsqueeze(-1)).any(dim=-1)
    return hit.to(torch.float32).mean().reshape(1)
