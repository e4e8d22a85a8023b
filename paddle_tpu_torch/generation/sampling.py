"""On-device sampling and speculative verification (counterpart of
``paddle_tpu/generation/sampling.py``).

Per-request knobs are batched operands: temperature, top-k, top-p and
seed enter a step as [B] tensors, so one step serves any mix of greedy
and sampled requests. Disabled knobs are in-band: ``temperature <= 0``
is greedy, ``top_k <= 0`` and ``top_p >= 1`` are unfiltered.

Keys are counter-based: token t of a request draws with
``fold_in(key(seed), t)`` (``kernels.sampling``, jax's threefry stream
bit for bit), so the serve loop and ``generate()`` emit the same sampled
tokens for a seed. Greedy rows take ``argmax(raw logits)``, bitwise the
greedy step's token.

The draws run through ``kernels.sampling.categorical_rows`` and
``uniform64_rows`` (one launch per [rows, V] family on the card); the
filters (one shared descending sort, softmax, cumsum) are tensor ops.
``propose_ngram_drafts`` is the host-side prompt-lookup drafter.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels.sampling import as_words, categorical_rows, uniform64_rows

__all__ = ["SamplingParams", "sampling_operands", "topk_mask", "topp_mask",
           "processed_logits", "sample_tokens", "verify_spans",
           "verify_spans_greedy", "propose_ngram_drafts"]

_NEG = -1e30


class SamplingParams(NamedTuple):
    """Per-request sampling knobs, carried as batched operands.

    ``temperature <= 0`` selects greedy argmax (``top_k``/``top_p`` are
    then irrelevant); ``top_k <= 0`` disables the k filter; ``top_p >=
    1`` disables the nucleus filter. Token t of the request draws with
    ``fold_in(key(seed), t)``."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


def sampling_operands(params: Sequence[Optional[SamplingParams]]):
    """Stack per-slot SamplingParams (None = greedy) into operand
    vectors: dict of numpy arrays ``temperature`` f32, ``top_k`` i32,
    ``top_p`` f32, ``seed`` i32."""
    n = len(params)
    temp = np.zeros((n,), np.float32)
    topk = np.zeros((n,), np.int32)
    topp = np.ones((n,), np.float32)
    seed = np.zeros((n,), np.int32)
    for i, sp in enumerate(params):
        if sp is None:
            continue
        temp[i] = float(sp.temperature)
        topk[i] = int(sp.top_k)
        topp[i] = float(sp.top_p)
        seed[i] = int(sp.seed)
    return {"temperature": temp, "top_k": topk, "top_p": topp, "seed": seed}


def _rows(x, shape, dtype, device):
    """An operand (python scalar, numpy array or tensor) broadcast to the
    row shape ``shape``."""
    return torch.as_tensor(x, dtype=dtype, device=device).expand(shape)


def _sorted_desc(logits):
    return torch.sort(logits, dim=-1, descending=True).values


def _kk(top_k, shape, v, device):
    """Per-row k: ``top_k <= 0`` keeps all v."""
    k = _rows(top_k, shape, torch.int64, device)
    return torch.where(k <= 0, v, torch.clamp(k, 1, v))


# ------------------------------------------------------------- filtering --
def topk_mask(logits, k):
    """Keep each row's top-k logits, mask the rest to -1e30; ``k`` a
    python int or per-row operand, ``k <= 0`` (or >= vocab) disables."""
    v = logits.shape[-1]
    kk = _kk(k, logits.shape[:-1], v, logits.device)
    kth = torch.gather(_sorted_desc(logits), -1, (kk - 1)[..., None])
    return torch.where(logits < kth, _NEG, logits)


def topp_mask(logits, p):
    """Nucleus filtering with a (per-row) ``p``: keep the smallest prefix
    of the sorted distribution with cumulative probability >= p (the
    argmax always survives); ``p >= 1`` disables."""
    sorted_desc = _sorted_desc(logits)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    pp = _rows(p, logits.shape[:-1], logits.dtype, logits.device)[..., None]
    drop = (cum - probs) > pp
    kept = torch.where(drop, torch.inf, sorted_desc)
    thr = torch.amin(kept, dim=-1, keepdim=True)
    return torch.where(logits < thr, _NEG, logits)


def processed_logits(logits, temperature, top_k, top_p):
    """The serving logits pipeline (temperature, top-k, top-p) with every
    knob a batched operand; ``logits`` [..., V] f32, the knobs
    broadcastable to the row shape. Rows with ``temperature <= 0`` are
    scaled by 1. One descending sort feeds both filters, collapsed into
    one per-row threshold (the reference's ``processed_logits``)."""
    dev = logits.device
    shape = logits.shape[:-1]
    t = _rows(temperature, shape, torch.float32, dev)
    safe_t = torch.where(t <= 0, 1.0, torch.clamp(t, min=1e-6))
    lg = logits / safe_t[..., None]
    v = lg.shape[-1]
    sorted_desc = _sorted_desc(lg)
    kk = _kk(top_k, shape, v, dev)
    kth = torch.gather(sorted_desc, -1, (kk - 1)[..., None])
    rank = torch.arange(v, device=dev)
    sl = torch.where(rank < kk[..., None], sorted_desc, _NEG)
    probs = torch.softmax(sl, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    pp = _rows(top_p, shape, torch.float32, dev)[..., None]
    drop = (cum - probs) > pp
    kept = torch.where(drop, torch.inf, sl)
    thr_p = torch.amin(kept, dim=-1, keepdim=True)
    thr = torch.maximum(thr_p, kth)      # keep iff inside both filters
    return torch.where(lg < thr, _NEG, lg)


# -------------------------------------------------------------- sampling --
def sample_tokens(logits, temperature, top_k, top_p, seed, counter,
                  with_logp=True):
    """One sampled (or greedy) token per row. ``logits`` [B, V] in the
    model's dtype (greedy rows take the argmax of the RAW logits, bitwise
    the greedy step's); the knobs [B] operands; ``counter`` [B] the
    per-request generated-token index. Returns (tok [B] int32, logp [B]
    f32: the token's log-probability under the distribution it was drawn
    from, processed for sampled rows and raw for greedy ones; None when
    ``with_logp`` is False)."""
    b = logits.shape[0]
    dev = logits.device
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    lg32 = logits.float()
    proc = processed_logits(lg32, temperature, top_k, top_p)
    sampled = categorical_rows(proc, as_words(seed, dev).expand(b),
                               as_words(counter, dev).expand(b))
    t = _rows(temperature, (b,), torch.float32, dev)
    tok = torch.where(t <= 0, greedy_tok, sampled)
    if not with_logp:
        return tok, None
    base = torch.where((t <= 0)[:, None], lg32, proc)
    logp = torch.log_softmax(base, dim=-1).gather(
        1, tok[:, None].long())[:, 0]
    return tok, logp


# ----------------------------------------------------- speculative verify --
def verify_spans(logits, span_ids, q_lens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0, counter=0, sampled_mode=True):
    """On-device verification of drafted token spans.

    Slot b ran a span of ``q_lens[b]`` tokens: position 0 its committed
    last token, positions 1..q_lens-1 drafted tokens; ``logits[b, i]``
    judges draft ``span_ids[b, i + 1]``. Returns ``(accepted [B] int32,
    bonus [B] int32)``: the longest accepted draft prefix and the token
    emitted at position ``accepted``; the slot commits accepted + 1
    tokens.

    Greedy rows (``temperature <= 0``) accept while the raw argmax
    equals the draft and take the argmax as bonus. Sampled rows accept
    draft d with probability p(d) (an f64 uniform ``u < p(d)``, as the
    reference draws it with x64 enabled); on rejection the bonus is drawn
    from p with d removed (renormalised), a dead residual falling back to
    the argmax; when every draft is accepted it is an ordinary sample at
    the last position. ``counter`` [B] is the generated-token index of
    the span's first emitted token; the row's key
    ``fold_in(key(seed), counter)`` is folded again with three disjoint
    offset families: ``[0, Qb - 1)`` the acceptance uniforms, ``[Qb,
    2 Qb)`` the normal draws, ``[2 Qb, 3 Qb)`` the residual draws.

    ``sampled_mode=False`` (a predictor built without sampling) is the
    greedy verify alone: argmax compare and nothing else."""
    b, qb, v = logits.shape
    dev = logits.device
    q_lens = torch.as_tensor(q_lens, device=dev).to(torch.int64)
    span_ids = torch.as_tensor(span_ids, device=dev).to(torch.int64)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)   # [B, Qb]
    if qb > 1:
        drafts = span_ids[:, 1:]                                 # [B, Qb-1]
        valid = torch.arange(1, qb, device=dev)[None, :] < q_lens[:, None]
        g_acc = greedy_tok[:, :-1].long() == drafts

    def lead_len(acc):
        lead = torch.cumprod(acc.to(torch.int32), dim=-1)
        return lead.sum(dim=-1).to(torch.int32)

    def sel(a):
        return a.gather(1, accepted[:, None].long())[:, 0]

    if not sampled_mode:
        accepted = lead_len(g_acc & valid) if qb > 1 else \
            torch.zeros(b, dtype=torch.int32, device=dev)
        return accepted, sel(greedy_tok)

    t = _rows(temperature, (b,), torch.float32, dev)
    lg32 = logits.float()
    proc = processed_logits(lg32, t[:, None], _rows(top_k, (b,), torch.int64,
                                                    dev)[:, None],
                            _rows(top_p, (b,), torch.float32, dev)[:, None])
    probs = torch.softmax(proc, dim=-1)                         # [B, Qb, V]
    seed = as_words(seed, dev).expand(b)
    counter = as_words(counter, dev).expand(b)

    def family(lo, n):
        """Per-(row, position) seed, counter and offsets lo .. lo+n-1,
        flattened row-major to [B * n]."""
        offs = torch.arange(lo, lo + n, device=dev, dtype=torch.int32)
        return (seed[:, None].expand(b, n).reshape(-1),
                counter[:, None].expand(b, n).reshape(-1),
                offs[None, :].expand(b, n).reshape(-1))

    if qb > 1:
        p_draft = probs[:, :-1].gather(-1, drafts[..., None])[..., 0]
        u = uniform64_rows(*family(0, qb - 1)).reshape(b, qb - 1)
        s_acc = u < p_draft.double()
        acc = torch.where((t <= 0)[:, None], g_acc, s_acc) & valid
        accepted = lead_len(acc)
    else:
        accepted = torch.zeros(b, dtype=torch.int32, device=dev)

    normal = categorical_rows(proc.reshape(b * qb, v),
                              *family(qb, qb)).reshape(b, qb)
    if qb > 1:
        # residual at position i: p_i with the judged draft removed; the
        # positions past the drafts keep a dummy (never selected)
        dr = torch.cat([span_ids[:, 1:], span_ids[:, -1:]], dim=1)
        onehot = torch.zeros(b, qb, v, dtype=torch.bool, device=dev)
        onehot.scatter_(-1, dr[..., None], True)
        res_lg = torch.where(onehot | (probs <= 0), _NEG,
                             torch.log(torch.clamp(probs, min=1e-30)))
        residual = categorical_rows(res_lg.reshape(b * qb, v),
                                    *family(2 * qb, qb)).reshape(b, qb)
        res_dead = torch.amax(res_lg, dim=-1) <= _NEG / 2
        residual = torch.where(res_dead, greedy_tok, residual)
    else:
        residual = normal
    all_acc = accepted.long() >= q_lens - 1
    s_bonus = torch.where(all_acc, sel(normal), sel(residual))
    bonus = torch.where(t <= 0, sel(greedy_tok), s_bonus).to(torch.int32)
    return accepted, bonus


def verify_spans_greedy(logits, span_ids, q_lens):
    """``verify_spans(..., sampled_mode=False)``: the longest draft
    prefix equal to the argmax and the argmax after it (the emitted
    stream is plain greedy decode). Returns ``(accepted, bonus)``."""
    return verify_spans(logits, span_ids, q_lens, sampled_mode=False)


# ------------------------------------------------------ prompt-lookup draft --
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
