"""Greedy speculative decoding helpers (counterpart of
``paddle_tpu/generation/sampling.py``: ``propose_ngram_drafts`` and the
greedy branch of ``verify_spans``).

The sampled branch and on-device sampling are not ported yet: the port's
predictor serves greedy requests only.
"""
from __future__ import annotations

from typing import List

import torch


def verify_spans_greedy(logits, span_ids, q_lens):
    """On-device greedy verification of drafted token spans.

    One verify step ran a span of ``q_lens[b]`` tokens per slot: position
    0 is the slot's committed last token, positions 1..q_lens-1 the
    drafted tokens. ``logits[b, i]`` is the next-token distribution after
    span position i, so position i judges draft ``span_ids[b, i + 1]``.
    A draft is accepted while the argmax equals it (the emitted stream is
    exactly plain greedy decode). Returns ``(accepted [B] int32, bonus
    [B] int32)``: the longest accepted draft prefix (0..q_lens-1) and the
    argmax at position ``accepted`` -- the slot commits accepted + 1
    tokens. Slots with q_lens == 1 carried no drafts: accepted = 0 and
    bonus is the plain decode argmax."""
    b, qb, _ = logits.shape
    greedy = logits.argmax(dim=-1).to(torch.int32)              # [B, Qb]
    if qb > 1:
        drafts = span_ids[:, 1:].to(torch.int32)
        valid = torch.arange(1, qb, device=logits.device)[None, :] \
            < q_lens.to(logits.device)[:, None]
        lead = torch.cumprod(((greedy[:, :-1] == drafts) & valid)
                             .to(torch.int32), dim=-1)
        accepted = lead.sum(dim=-1).to(torch.int32)
    else:
        accepted = torch.zeros(b, dtype=torch.int32, device=logits.device)
    bonus = greedy.gather(1, accepted[:, None].long())[:, 0]
    return accepted, bonus


def propose_ngram_drafts(history: List[int], k: int,
                         ngram_max: int = 3,
                         window: int = 4096) -> List[int]:
    """Prompt-lookup drafting (host-side, no second model): match the
    longest suffix n-gram of `history` (n = ngram_max down to 1)
    against an earlier occurrence in the SAME history (prompt +
    generation) and propose up to `k` tokens that followed the most
    recent match. Returns [] when nothing matches -- the tick then runs
    as a plain decode step. `window` bounds the backward scan so a very
    long history costs O(window) per tick, not O(n^2)."""
    n = len(history)
    if k <= 0 or n < 2:
        return []
    lo = max(0, n - window)
    for m in range(min(ngram_max, n - 1), 0, -1):
        pat = history[n - m:]
        for j in range(n - m - 1, lo - 1, -1):
            if history[j:j + m] == pat:
                return list(history[j + m:j + m + k])
    return []
