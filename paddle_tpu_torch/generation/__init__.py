"""Counterpart of ``paddle_tpu/generation``: the paged KV cache of serving,
on-device sampling and speculative verification (``sampling``), the
logits processors, and ``GenerationMixin.generate``.

``generate`` runs the reference's eager path (``_generate_eager``): a
full forward of the prompt and the tokens so far at every step, greedy
or sampled through the same ``sample_tokens`` the serve loop uses. Row b
of a call seeds at ``base_seed + b`` and token t draws with counter t, so
a seed gives the serve loop's tokens. The reference's static-cache path
and beam search are not ported here: models mix this in with
``supports_static_cache = False``, and beam search raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import logits_process as LP
from .kv_cache import (PagedCacheEntry, PagedKVCache, PagedKVPool,
                       PrefixCache, paged_cache_mixed_update_attend,
                       paged_cache_update_attend, prefix_page_keys,
                       span_index)
from .sampling import (SamplingParams, propose_ngram_drafts, sample_tokens,
                       verify_spans, verify_spans_greedy)

__all__ = ["GenerationConfig", "GenerationMixin", "PagedCacheEntry",
           "PagedKVCache", "PagedKVPool", "PrefixCache", "SamplingParams",
           "paged_cache_mixed_update_attend", "paged_cache_update_attend",
           "prefix_page_keys", "propose_ngram_drafts", "span_index",
           "verify_spans", "verify_spans_greedy"]


@dataclass
class GenerationConfig:
    """Knob bag mirroring PaddleNLP GenerationConfig field names."""
    max_new_tokens: int = 32
    min_new_tokens: int = 0
    decode_strategy: str = "greedy_search"  # "sampling" | "beam_search"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    num_beams: int = 1
    length_penalty: float = 0.0
    early_stopping: bool = False
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    use_cache: bool = True
    seed: Optional[int] = None


def _left_pad(ids: np.ndarray, mask: np.ndarray, pad_id: int):
    """Roll each row so padding sits on the left (decoder-only layout)."""
    out_ids = np.full_like(ids, pad_id)
    out_mask = np.zeros_like(mask)
    n = ids.shape[1]
    for b in range(ids.shape[0]):
        keep = ids[b][mask[b].astype(bool)]
        out_ids[b, n - len(keep):] = keep
        out_mask[b, n - len(keep):] = 1
    return out_ids, out_mask


def _host(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


class GenerationMixin:
    """Adds ``.generate()`` to causal-LM modules whose ``forward(ids)``
    returns [B, S, V] logits."""

    supports_static_cache = False

    def generate(self, input_ids, attention_mask=None, generation_config=None,
                 **kwargs):
        """Returns (generated_ids [B, max_new_tokens] int32, scores [B]
        f32), both on the CPU.

        ``generated_ids`` holds only NEW tokens; positions after eos are
        ``pad_token_id``. ``scores`` is the mean log-probability of the
        emitted tokens. ``decode_strategy`` is "greedy_search" or
        "sampling" (temperature, top_k, top_p; ``seed`` anchors the keys,
        else one host draw does). Beam search is not ported yet and
        raises ``NotImplementedError``."""
        cfg = (dataclasses.replace(generation_config)
               if generation_config is not None else GenerationConfig())
        for k, v in kwargs.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        if cfg.decode_strategy == "beam_search" or (cfg.num_beams or 1) > 1:
            raise NotImplementedError(
                "beam search is not ported yet: it comes with the static-"
                "cache generate path and GPT (ROADMAP Queue 1 item 5)")
        ids = _host(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        mask = np.ones_like(ids, dtype=np.int32) if attention_mask is None \
            else _host(attention_mask).astype(np.int32)
        if cfg.seed is not None:
            base_seed = int(cfg.seed)
        else:
            # one host draw anchors the call's counter-based key streams
            from ..framework.random import generation_seed
            base_seed = generation_seed()
        out, scores = self._generate_eager(ids, mask, base_seed, cfg)
        return torch.from_numpy(out), torch.from_numpy(scores)

    def _generate_eager(self, ids, mask, base_seed, cfg):
        # ``forward(ids)`` takes no mask or positions, so a padded batch
        # runs row by row; row b seeds at base_seed + b, as in the batch
        if (mask == 0).any():
            outs, scores = [], []
            for b in range(ids.shape[0]):
                row = ids[b][mask[b].astype(bool)][None, :]
                o, s = self._generate_eager(
                    row, np.ones_like(row, dtype=np.int32), base_seed + b,
                    cfg)
                outs.append(o[0])
                scores.append(s[0])
            return np.stack(outs), np.asarray(scores, np.float32)
        return self._generate_eager_batch(ids, mask, base_seed, cfg)

    @torch.no_grad()
    def _generate_eager_batch(self, ids, mask, base_seed, cfg):
        greedy = cfg.decode_strategy in ("greedy_search", "greedy")
        B = ids.shape[0]
        dev = next(self.parameters()).device
        s_temp = np.full((B,), 0.0 if greedy else float(cfg.temperature),
                         np.float32)
        s_topk = np.full((B,), int(cfg.top_k), np.int32)
        s_topp = np.full((B,), float(cfg.top_p), np.float32)
        s_seed = (int(base_seed) + np.arange(B)).astype(np.int32)
        cur = np.asarray(ids)
        finished = np.zeros((B,), bool)
        outs, logps = [], []
        counts = None
        if cfg.repetition_penalty != 1.0:
            counts = np.zeros((B, self.config.vocab_size), np.int32)
            for b in range(B):
                np.add.at(counts[b], cur[b][mask[b].astype(bool)], 1)
        for step in range(cfg.max_new_tokens):
            out = self.forward(torch.as_tensor(cur, dtype=torch.long,
                                               device=dev))
            lg = (out[0] if isinstance(out, tuple) else out)[:, -1, :].float()
            lg = LP.min_length_mask(lg, step, cfg.min_new_tokens,
                                    cfg.eos_token_id)
            if counts is not None:
                lg = LP.repetition_penalty(lg, torch.as_tensor(counts),
                                           cfg.repetition_penalty)
            # token `step` of row b draws with fold_in(key(base_seed + b),
            # step): the serve loop's stream
            tok, logp = sample_tokens(lg, s_temp, s_topk, s_topp, s_seed,
                                      np.full((B,), step, np.int32))
            tok = tok.cpu().numpy()
            logp = logp.cpu().numpy()
            emit = np.where(finished, cfg.pad_token_id, tok)
            logps.append(np.where(finished, 0.0, logp))
            outs.append(emit)
            if cfg.eos_token_id is not None:
                finished |= tok == cfg.eos_token_id
            if counts is not None:
                np.add.at(counts, (np.arange(B), emit),
                          (~finished).astype(np.int32))
            cur = np.concatenate([cur, emit[:, None]], axis=1)
            if finished.all():
                break
        toks = np.stack(outs, axis=1).astype(np.int32)
        if toks.shape[1] < cfg.max_new_tokens:   # pad early-stopped batches
            padw = cfg.max_new_tokens - toks.shape[1]
            toks = np.pad(toks, ((0, 0), (0, padw)),
                          constant_values=cfg.pad_token_id)
        lp = np.stack(logps, axis=1)
        emitted = toks[:, :lp.shape[1]] != cfg.pad_token_id
        denom = np.maximum(emitted.sum(axis=1), 1)
        scores = (lp * emitted).sum(axis=1) / denom
        return toks, scores.astype(np.float32)
