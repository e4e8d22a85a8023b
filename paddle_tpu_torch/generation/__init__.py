"""Counterpart of ``paddle_tpu/generation``: the KV caches (``kv_cache``:
the static cache of ``generate()`` and the paged cache of serving),
on-device sampling and speculative verification (``sampling``), the
logits processors, and ``GenerationMixin.generate``.

``generate`` takes the reference's routes (``paddle_tpu/generation/
__init__.py:142-156``): the static-cache route when ``use_cache`` and the
model opts in (``supports_static_cache``), else the eager route. The
static route (``_generate_static``) left-pads the batch, preallocates one
[B, S + N, n_kv_heads, head_dim] K and V buffer per layer, runs the
prompt once (``_cache_prefill``) and then one token per step against the
cache, with position ids ``clip(cumsum(mask) - 1, 0)`` per row and a
bool key mask; where the reference compiles the loop into one program
(``lax.scan``), the port runs it eagerly, step by step on the device,
with no host sync until the end. The eager route (``_generate_eager``)
recomputes the whole sequence every token. Both draw through the same
``sample_tokens`` the serve loop uses: row b of a call seeds at
``base_seed + b`` and token t draws with counter t, so a seed gives the
serve loop's tokens on either route. Beam search is not ported and
raises.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import logits_process as LP
from .kv_cache import (PagedCacheEntry, PagedKVCache, PagedKVPool,
                       PrefixCache, StaticCacheEntry, StaticKVCache,
                       paged_cache_mixed_update_attend,
                       paged_cache_update_attend, prefix_page_keys,
                       span_index, static_cache_update)
from .sampling import (SamplingParams, propose_ngram_drafts, sample_tokens,
                       verify_spans, verify_spans_greedy)

__all__ = ["GenerationConfig", "GenerationMixin", "PagedCacheEntry",
           "PagedKVCache", "PagedKVPool", "PrefixCache", "SamplingParams",
           "StaticCacheEntry", "StaticKVCache",
           "paged_cache_mixed_update_attend", "paged_cache_update_attend",
           "prefix_page_keys", "propose_ngram_drafts", "span_index",
           "static_cache_update", "verify_spans", "verify_spans_greedy"]


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
    returns [B, S, V] logits; a model that sets ``supports_static_cache``
    also takes ``forward(ids, attn_mask=, position_ids=,
    past_key_values=StaticKVCache, use_cache=True)``."""

    supports_static_cache = False

    # -- model hooks (overridable) ---------------------------------------
    def _cache_spec(self):
        cfg = self.config
        n_kv = getattr(cfg, "num_key_value_heads", None) or \
            cfg.num_attention_heads
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        return cfg.num_hidden_layers, n_kv, head_dim

    def _cache_dtype(self):
        for p in self.parameters():
            return p.dtype
        return torch.float32

    # -- public API ------------------------------------------------------
    def generate(self, input_ids, attention_mask=None, generation_config=None,
                 **kwargs):
        """Returns (generated_ids [B, max_new_tokens] int32, scores [B]
        f32), both on the CPU.

        ``generated_ids`` holds only NEW tokens; positions after eos are
        ``pad_token_id``. ``scores`` is the mean log-probability of the
        emitted tokens. ``decode_strategy`` is "greedy_search" or
        "sampling" (temperature, top_k, top_p; ``seed`` anchors the keys,
        else one host draw does). ``use_cache=False`` takes the eager
        route. Beam search is not ported yet and raises
        ``NotImplementedError``."""
        cfg = (dataclasses.replace(generation_config)
               if generation_config is not None else GenerationConfig())
        for k, v in kwargs.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        beam = cfg.decode_strategy == "beam_search"
        if beam:
            raise NotImplementedError(
                "beam search is not ported yet (ROADMAP Queue 1: beam "
                "search over the static cache runner)")
        if (cfg.num_beams or 1) > 1:
            raise ValueError(
                f"num_beams={cfg.num_beams} requires "
                f"decode_strategy='beam_search' (got {cfg.decode_strategy!r})")
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
        if cfg.use_cache and self.supports_static_cache:
            # decoder-only layout: padding on the LEFT, so every row's
            # last prompt token shares one slot
            if (mask == 0).any():
                ids, mask = _left_pad(ids, mask, cfg.pad_token_id)
            out, scores = self._generate_static(ids, mask, base_seed, cfg)
        else:
            out, scores = self._generate_eager(ids, mask, base_seed, cfg)
        return torch.from_numpy(out), torch.from_numpy(scores)

    # -- static-cache route ----------------------------------------------
    def _generate_static(self, ids, mask, base_seed, cfg):
        n_layers, n_kv, head_dim = self._cache_spec()
        B, S = ids.shape
        N = int(cfg.max_new_tokens)
        greedy = cfg.decode_strategy in ("greedy_search", "greedy")
        fn = self._build_static_fn(n_layers, n_kv, head_dim, B, S, N, S + N,
                                   greedy, cfg)
        dev = next(self.parameters()).device
        seeds = torch.as_tensor(
            (int(base_seed) + np.arange(B)).astype(np.int32), device=dev)
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                out, scores = fn(
                    torch.as_tensor(ids, dtype=torch.long, device=dev),
                    torch.as_tensor(mask, dtype=torch.int32, device=dev),
                    seeds)
        finally:
            if was_training:
                self.train()
        return (out.cpu().numpy().astype(np.int32),
                scores.cpu().numpy().astype(np.float32))

    def _make_cache_runner(self, n_layers):
        """run_model(ids2d, amask, posid, cachepos, kv) -> (logits, kv):
        one forward over the static cache, whose buffers (``kv``, K and V
        per layer) it writes in place at ``cachepos``."""
        def run_model(ids2d, amask, posid, cachepos, kv):
            entries = StaticKVCache(
                [StaticCacheEntry(kv[2 * i], kv[2 * i + 1], cachepos)
                 for i in range(n_layers)])
            logits, _ = self.forward(ids2d, attn_mask=amask,
                                     position_ids=posid,
                                     past_key_values=entries, use_cache=True)
            return logits, kv
        return run_model

    @staticmethod
    def _cache_prefill(run_model, ids, mask, n_layers, n_kv, head_dim, ML,
                       dtype):
        """Zero the [rows, ML, ...] cache, build the causal + padding
        prefill mask and run the prompt. Returns (logits, kv, kmask,
        posid). A left-pad query row sees no valid key: its (finite)
        output is never read, and later steps mask its cache slots."""
        rows, S = ids.shape
        dev = ids.device
        posid = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        kv = [torch.zeros((rows, ML, n_kv, head_dim), dtype=dtype,
                          device=dev) for _ in range(2 * n_layers)]
        kmask = torch.cat([mask.bool(), torch.zeros((rows, ML - S),
                                                    dtype=torch.bool,
                                                    device=dev)], dim=1)
        i_ids = torch.arange(S, device=dev)[:, None]
        j_ids = torch.arange(ML, device=dev)[None, :]
        amask = (j_ids <= i_ids)[None, None] & kmask[:, None, None, :]
        logits, kv = run_model(ids, amask, posid, 0, kv)
        return logits, kv, kmask, posid

    def _build_static_fn(self, n_layers, n_kv, head_dim, B, S, N, ML,
                         greedy, cfg):
        """The reference's ``_build_static_fn`` as an eager loop:
        ``raw(ids, mask, seeds)`` -> (tokens [B, N] int32, scores [B])
        on the model's device."""
        dtype = self._cache_dtype()
        eos, pad = cfg.eos_token_id, cfg.pad_token_id
        rep_pen = float(cfg.repetition_penalty)
        min_new = int(cfg.min_new_tokens)
        vocab = self.config.vocab_size
        track_counts = rep_pen != 1.0
        run_model = self._make_cache_runner(n_layers)
        temperature = 0.0 if greedy else float(cfg.temperature)

        def sample_step(logits, seeds, counts, step_idx):
            lg = LP.min_length_mask(logits.float(), step_idx, min_new, eos)
            if track_counts:
                lg = LP.repetition_penalty(lg, counts, rep_pen)
            if greedy:
                # sample_tokens' greedy rows, without the unused draw
                tok = torch.argmax(lg, dim=-1).to(torch.int32)
                logp = torch.log_softmax(lg, dim=-1).gather(
                    1, tok[:, None].long())[:, 0]
                return tok, logp
            return sample_tokens(
                lg, temperature, int(cfg.top_k), float(cfg.top_p), seeds,
                torch.full((B,), step_idx, dtype=torch.int32,
                           device=lg.device))

        def raw(ids, mask, seeds):
            dev = ids.device
            rows = torch.arange(B, device=dev)
            real_len = mask.sum(dim=1)
            logits, kv, kmask, _ = self._cache_prefill(
                run_model, ids, mask, n_layers, n_kv, head_dim, ML, dtype)
            counts = None
            if track_counts:
                counts = torch.zeros((B, vocab), dtype=torch.int32,
                                     device=dev)
                counts.scatter_add_(1, ids, mask)
            tok, logp = sample_step(logits[:, -1, :], seeds, counts, 0)
            fin = (tok == eos) if eos is not None \
                else torch.zeros((B,), dtype=torch.bool, device=dev)
            if track_counts:
                counts[rows, tok.long()] += 1
            toks, logps = [tok], [logp]
            for step in range(N - 1):
                slot = S + step
                kmask[:, slot] = True
                pid = (real_len + step)[:, None]
                lg, kv = run_model(tok[:, None].long(),
                                   kmask[:, None, None, :], pid, slot, kv)
                ntok, nlogp = sample_step(lg[:, -1, :], seeds, counts,
                                          step + 1)
                newly_fin = fin | (ntok == eos) if eos is not None else fin
                emit = torch.where(fin, torch.full_like(ntok, pad), ntok)
                toks.append(emit)
                logps.append(torch.where(fin, 0.0, nlogp))
                if track_counts:
                    counts[rows, emit.long()] += (~fin).to(torch.int32)
                tok, fin = emit, newly_fin
            all_toks = torch.stack(toks, dim=1)
            all_logps = torch.stack(logps, dim=1)
            emitted = all_toks != pad
            denom = torch.clamp(emitted.sum(dim=1), min=1)
            return all_toks, (all_logps * emitted).sum(dim=1) / denom
        return raw

    # -- eager route (no cache protocol needed) --------------------------
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
