"""BERT / ERNIE sequence-classification fine-tuning on one GPU: the
counterpart of ``examples/bert_finetune.py``'s single-device branch
(eager ``loss.backward(); opt.step(); opt.clear_grad()`` with AdamW over
``LinearWarmup(PolynomialDecay)``, float32, synthetic data).

    python -m paddle_tpu_torch.examples.bert_finetune            # BERT-base
    python -m paddle_tpu_torch.examples.bert_finetune --model ernie
    python -m paddle_tpu_torch.examples.bert_finetune --smoke --device cpu

``--min-len L`` draws each row's length in [L, seq] and passes the
padding as ``attention_mask`` (BERT: additive; ERNIE: boolean); without
it every token is real, as in the reference example. ``--dp > 1`` (data
parallel) is not ported and raises. ``main`` returns the losses and the
step times so that other scripts (``chip_smoke.py``) can drive it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..framework import random as prandom
from ..framework import resolve_device
from ..models import (BertConfig, BertForSequenceClassification, ErnieConfig,
                      ErnieForSequenceClassification)
from ..nn import CrossEntropyLoss
from ..optimizer import AdamW
from ..optimizer.lr import LinearWarmup, PolynomialDecay

NUM_CLASSES = 4


def synthetic_batches(rng, vocab, batch, seq, num_classes, steps,
                      min_len=None):
    """The reference example's (ids, labels) draws, plus an [B, S] 1/0
    attention mask of lengths drawn in [min_len, seq] after them (None
    without ``min_len``)."""
    for _ in range(steps):
        ids = rng.randint(0, vocab, (batch, seq))
        labels = rng.randint(0, num_classes, (batch,))
        mask = None
        if min_len is not None:
            lens = rng.randint(min_len, seq + 1, (batch,))
            mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
        yield ids, labels, mask


def build_model(name, smoke, device, **overrides):
    """(model, config) of the example: BERT with ``num_labels`` 4 or ERNIE
    with ``num_classes`` 4, tiny under ``smoke``; ``overrides`` go to the
    config (e.g. dropout probabilities)."""
    if name == "bert":
        cfg = (BertConfig.tiny if smoke else BertConfig)(
            num_labels=NUM_CLASSES, **overrides)
        return BertForSequenceClassification(cfg, device=device), cfg
    cfg = (ErnieConfig.tiny if smoke else ErnieConfig)(**overrides)
    return ErnieForSequenceClassification(cfg, num_classes=NUM_CLASSES,
                                          device=device), cfg


def build_optimizer(model, lr, steps):
    """The example's AdamW (weight decay 0.01, ``apply_decay_param_fun``
    rejecting names with "norm" or "bias") over
    ``LinearWarmup(PolynomialDecay(lr, steps))`` with a tenth of the
    steps (at least one) of warm-up from 0."""
    sched = LinearWarmup(PolynomialDecay(lr, steps),
                         warmup_steps=max(steps // 10, 1), start_lr=0.0,
                         end_lr=lr)
    return AdamW(learning_rate=sched, parameters=model.parameters(),
                 weight_decay=0.01,
                 apply_decay_param_fun=lambda n: "norm" not in n
                 and "bias" not in n)


def train_step(model, opt, crit, ids, labels, mask=None):
    """One step of the example's loop; returns the loss tensor."""
    logits = model(ids, attention_mask=mask)
    loss = crit(logits, labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    opt._learning_rate.step()
    return loss


def to_device(batch, device):
    ids, labels, mask = batch
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device),
            None if mask is None else torch.from_numpy(mask).to(device))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--smoke", action="store_true",
                   help="tiny configuration")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--model", choices=["bert", "ernie"], default="bert")
    p.add_argument("--device", default="cuda")
    p.add_argument("--min-len", type=int, default=None,
                   help="draw row lengths in [min-len, seq] and pad the "
                        "rest through attention_mask")
    args = p.parse_args(argv)
    if args.dp > 1:
        raise NotImplementedError(
            "--dp > 1: data-parallel fine-tuning is not ported yet")
    dev = resolve_device(args.device)

    prandom.seed(0)
    model, cfg = build_model(args.model, args.smoke, dev)
    opt = build_optimizer(model, args.lr, args.steps)
    crit = CrossEntropyLoss()
    model.train()

    rng = np.random.RandomState(0)
    losses, step_s = [], []
    for step, batch in enumerate(synthetic_batches(
            rng, cfg.vocab_size, args.batch, args.seq, NUM_CLASSES,
            args.steps, args.min_len)):
        t0 = time.perf_counter()
        loss = train_step(model, opt, crit, *to_device(batch, dev))
        losses.append(float(loss.detach()))  # waits for the whole step
        step_s.append(time.perf_counter() - t0)
        if step % 5 == 0:
            print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
    return {"losses": losses, "step_s": step_s, "model": model,
            "optimizer": opt, "criterion": crit, "config": cfg,
            "tokens_per_step": args.batch * args.seq}


if __name__ == "__main__":
    main()
