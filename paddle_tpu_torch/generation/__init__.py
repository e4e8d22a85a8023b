"""Counterpart of ``paddle_tpu/generation``: the KV caches (``kv_cache``:
the static cache of ``generate()`` and the paged cache of serving),
on-device sampling and speculative verification (``sampling``), the
logits processors, and ``GenerationMixin.generate``.

``generate`` takes the reference's routes (``paddle_tpu/generation/
__init__.py:132-156``): greedy and sampled decoding and beam search each
take the static-cache route when ``use_cache`` and the model opts in
(``supports_static_cache``), else the eager route. The static route
left-pads the batch, preallocates one [rows, S + N, n_kv_heads,
head_dim] K and V buffer per layer, runs the prompt once
(``_cache_prefill``) and then one token per step against the cache, with
position ids ``clip(cumsum(mask) - 1, 0)`` per row and a bool key mask.
The eager routes recompute the whole sequence every token.

Where the reference compiles each static-route signature into one XLA
program (``jax.jit`` of a ``lax.scan``, kept in ``_gen_cache``), the port
keeps one program per signature in ``_gen_cache`` too: on a CUDA model
the first call of a signature runs the step loop eagerly (its result is
returned) and captures it into one CUDA graph (``framework.graphs``,
one graph memory pool per device); every later call copies ids, mask
and seeds into the graph's static inputs and replays it. The graph reads
the weights by address: a load in place is served as it is, a rebound
parameter or buffer (another tensor, or another storage) is re-captured
(``graph_stats["recaptures"]``). A capture that fails raises. On the CPU
the same loop runs eagerly. The loop never syncs with the host.

Greedy and sampled decoding draw through the same ``sample_tokens`` the
serve loop uses: row b of a call seeds at ``base_seed + b`` and token t
draws with counter t, so a seed gives the serve loop's tokens on either
route. Beam search keeps beams as rows (row ``b * K + j`` is beam j of
sequence b), picks the K best of the [B, K * V] continuations with
``jax.lax.top_k``'s order (ties to the lower index), freezes finished
beams on a pad continuation and ranks the beams at the end by
``score / ((5 + len) / 6) ** length_penalty``.
"""
from __future__ import annotations

import dataclasses
import time
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
           "StaticCacheEntry", "StaticKVCache", "graph_stats",
           "paged_cache_mixed_update_attend", "paged_cache_update_attend",
           "prefix_page_keys", "propose_ngram_drafts", "span_index",
           "static_cache_update", "verify_spans", "verify_spans_greedy"]

# the static route's CUDA graphs in this process: captures (a first call
# of a signature), replays, re-captures after a rebound weight, and the
# seconds the captures took
graph_stats = {"captures": 0, "replays": 0, "recaptures": 0,
               "capture_s": 0.0}

_NEG = -1e9       # the reference's beam-search NEG


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
    # accepted for config parity: with frozen finished beams the result
    # is the same either way
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


def _repeat_rows(x, k):
    """Each row of ``x`` k times in a row (``jnp.repeat(x, k, axis=0)``)."""
    return x[:, None].expand(x.shape[0], k, *x.shape[1:]).reshape(
        x.shape[0] * k, *x.shape[1:])


def _top_k(x, k):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values in the order of their indices."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_select(scores, fin, logp, pad):
    """One beam step's choice. ``scores`` [B, K] the beams' log-probs,
    ``fin`` [B, K] finished, ``logp`` [B, K, V] the next token's
    log-probs. A finished beam continues only with pad at its own score.
    Returns (best [B, K] scores, parent [B, K], token [B, K])."""
    b, k, v = logp.shape
    cand = scores[:, :, None] + logp
    frozen = torch.full_like(cand, _NEG)
    frozen[:, :, pad] = scores
    cand = torch.where(fin[:, :, None], frozen, cand)
    best, idx = _top_k(cand.reshape(b, k * v), k)
    return best, idx // v, (idx % v).to(torch.int32)


def _length_norm(lens, lp_exp):
    """GNMT: ((5 + len) / 6) ** length_penalty, len at least 1."""
    return ((5.0 + torch.clamp(lens, min=1).float()) / 6.0) ** lp_exp


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
        ``pad_token_id``. ``decode_strategy`` is "greedy_search",
        "sampling" (temperature, top_k, top_p; ``seed`` anchors the keys,
        else one host draw does) or "beam_search" (``num_beams``,
        ``length_penalty``). For greedy and sampling ``scores`` is the
        mean log-probability of the emitted tokens; for beam search the
        best beam's log-probability over the GNMT length penalty
        ((5 + len) / 6) ** length_penalty. ``use_cache=False`` takes the
        eager route."""
        cfg = (dataclasses.replace(generation_config)
               if generation_config is not None else GenerationConfig())
        for k, v in kwargs.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        beam = cfg.decode_strategy == "beam_search"
        if not beam and (cfg.num_beams or 1) > 1:
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
        static = cfg.use_cache and self.supports_static_cache
        if static and (mask == 0).any():
            # decoder-only layout: padding on the LEFT, so every row's
            # last prompt token shares one slot
            ids, mask = _left_pad(ids, mask, cfg.pad_token_id)
        if beam and static:
            out, scores = self._generate_beam(ids, mask, cfg)
        elif beam:
            out, scores = self._generate_beam_eager(ids, mask, cfg)
        elif static:
            out, scores = self._generate_static(ids, mask, base_seed, cfg)
        else:
            out, scores = self._generate_eager(ids, mask, base_seed, cfg)
        return torch.from_numpy(out), torch.from_numpy(scores)

    # -- one program per signature ---------------------------------------
    def _run_program(self, sig, build, args):
        """Run the static-route program of signature ``sig`` on ``args``
        (device tensors); ``build()`` makes its step loop. On the CPU the
        loop runs eagerly. On CUDA the first call runs it eagerly and
        captures it; later calls replay the graph, and a rebound weight
        re-captures. Returns the program's outputs."""
        cache = self.__dict__.get("_gen_cache")
        if cache is None:
            cache = self._gen_cache = {}
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self._dispatch(cache, sig, build, args)
        finally:
            if was_training:
                self.train()

    def _dispatch(self, cache, sig, build, args):
        from ..framework.graphs import (Captured, GraphProgram,
                                        capture_stream, graph_pool)
        dev = args[0].device
        entry = cache.get(sig)
        if dev.type != "cuda":
            if entry is None or isinstance(entry, Captured):
                entry = cache[sig] = build()
            return entry(*args)
        baked = [*self.parameters(), *self.buffers()]
        if isinstance(entry, Captured) and not entry.reads(baked):
            # the graph would read the old storage: capture again
            del cache[sig]
            entry = None
            graph_stats["recaptures"] += 1
        if isinstance(entry, Captured):
            graph_stats["replays"] += 1
            return entry.program(*args)
        raw = build()
        out = raw(*args)
        t0 = time.perf_counter()
        program = GraphProgram(raw, args, graph_pool(dev, "generate"),
                               capture_stream(dev))
        graph_stats["capture_s"] += time.perf_counter() - t0
        graph_stats["captures"] += 1
        cache[sig] = Captured(program, baked)
        return out

    # -- static-cache route ----------------------------------------------
    def _generate_static(self, ids, mask, base_seed, cfg):
        n_layers, n_kv, head_dim = self._cache_spec()
        B, S = ids.shape
        N = int(cfg.max_new_tokens)
        greedy = cfg.decode_strategy in ("greedy_search", "greedy")
        sig = (B, S, N, greedy, cfg.top_k, cfg.eos_token_id,
               cfg.pad_token_id, cfg.min_new_tokens,
               float(cfg.temperature), float(cfg.top_p),
               float(cfg.repetition_penalty))
        dev = next(iter(self.parameters())).device
        seeds = torch.as_tensor(
            (int(base_seed) + np.arange(B)).astype(np.int32), device=dev)
        out, scores = self._run_program(
            sig, lambda: self._build_static_fn(
                n_layers, n_kv, head_dim, B, S, N, S + N, greedy, cfg),
            (torch.as_tensor(ids, dtype=torch.long, device=dev),
             torch.as_tensor(mask, dtype=torch.int32, device=dev), seeds))
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
        """The reference's ``_build_static_fn``: ``raw(ids, mask,
        seeds)`` -> (tokens [B, N] int32, scores [B]) on the model's
        device, with no host sync (it is captured on CUDA)."""
        dtype = self._cache_dtype()
        eos, pad = cfg.eos_token_id, cfg.pad_token_id
        rep_pen = float(cfg.repetition_penalty)
        min_new = int(cfg.min_new_tokens)
        vocab = self.config.vocab_size
        track_counts = rep_pen != 1.0
        run_model = self._make_cache_runner(n_layers)

        def sample_step(logits, seeds, counts, step_idx, knobs):
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
                lg, *knobs, seeds,
                torch.full((B,), step_idx, dtype=torch.int32,
                           device=lg.device))

        def raw(ids, mask, seeds):
            dev = ids.device
            rows = torch.arange(B, device=dev)
            # the knobs as fills on the device (a capture copies nothing
            # from the host)
            knobs = None if greedy else (
                torch.full((B,), float(cfg.temperature), device=dev),
                torch.full((B,), int(cfg.top_k), dtype=torch.int64,
                           device=dev),
                torch.full((B,), float(cfg.top_p), device=dev))
            real_len = mask.sum(dim=1)
            logits, kv, kmask, _ = self._cache_prefill(
                run_model, ids, mask, n_layers, n_kv, head_dim, ML, dtype)
            counts = None
            if track_counts:
                counts = torch.zeros((B, vocab), dtype=torch.int32,
                                     device=dev)
                counts.scatter_add_(1, ids, mask)
            tok, logp = sample_step(logits[:, -1, :], seeds, counts, 0,
                                    knobs)
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
                                          step + 1, knobs)
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

    # -- beam search over the static cache -------------------------------
    def _generate_beam(self, ids, mask, cfg):
        """Beam search over the static KV cache (the reference's
        ``_generate_beam``): beams live as rows ([B * K, ...]), and each
        step reorders the cache by the chosen parent beams."""
        n_layers, n_kv, head_dim = self._cache_spec()
        B, S = ids.shape
        K = int(cfg.num_beams)
        N = int(cfg.max_new_tokens)
        sig = ("beam", B, S, N, K, cfg.eos_token_id, cfg.pad_token_id,
               float(cfg.length_penalty), cfg.min_new_tokens)
        dev = next(iter(self.parameters())).device
        out, scores = self._run_program(
            sig, lambda: self._build_beam_fn(n_layers, n_kv, head_dim, B, S,
                                             N, S + N, K, cfg),
            (torch.as_tensor(ids, dtype=torch.long, device=dev),
             torch.as_tensor(mask, dtype=torch.int32, device=dev)))
        return (out.cpu().numpy().astype(np.int32),
                scores.cpu().numpy().astype(np.float32))

    def _build_beam_fn(self, n_layers, n_kv, head_dim, B, S, N, ML, K,
                       cfg):
        """``raw(ids, mask)`` -> (tokens [B, N] int32, scores [B]): the
        prompt runs once on B rows and its cache is repeated to the
        B * K beam rows. Step t writes history column t + 1. The
        reference skips the model once every beam has finished
        (``lax.cond``); a host branch would break the capture, so here
        such a step still runs the model and is made an exact identity
        (parents ``arange(K)``, scores kept, the frozen beams' pad
        continuation written where pad already stands)."""
        dtype = self._cache_dtype()
        eos, pad = cfg.eos_token_id, cfg.pad_token_id
        lp_exp = float(cfg.length_penalty)
        min_new = int(cfg.min_new_tokens)
        vocab = self.config.vocab_size
        BK = B * K
        run_model = self._make_cache_runner(n_layers)

        def raw(ids, mask):
            dev = ids.device
            logits, kv, kmask1, _ = self._cache_prefill(
                run_model, ids, mask, n_layers, n_kv, head_dim, ML, dtype)
            kv = [_repeat_rows(a, K) for a in kv]
            kmask = _repeat_rows(kmask1, K)
            real_len = _repeat_rows(mask.sum(dim=1), K)
            logp0 = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
            if eos is not None and min_new > 0:
                logp0[:, eos] = _NEG
            scores, tok = _top_k(logp0, K)                      # [B, K]
            tok = tok.to(torch.int32)
            fin = (tok == eos) if eos is not None \
                else torch.zeros((B, K), dtype=torch.bool, device=dev)
            hist = torch.full((B, K, N), pad, dtype=torch.int32, device=dev)
            hist[:, :, 0] = tok
            base = (torch.arange(B, device=dev) * K)[:, None]
            ident = torch.arange(K, device=dev)[None, :].expand(B, K)
            for t in range(N - 1):
                slot = S + t
                kmask[:, slot] = True
                pid = (real_len + t)[:, None]
                lg, kv = run_model(tok.reshape(BK, 1).long(),
                                   kmask[:, None, None, :], pid, slot, kv)
                logp = torch.log_softmax(lg[:, -1, :].float(), dim=-1)
                logp = logp.reshape(B, K, vocab)
                if eos is not None and t + 1 < min_new:
                    logp[:, :, eos] = _NEG
                best, parent, ntok = _beam_select(scores, fin, logp, pad)
                # every beam finished: the reference's skipped step
                done = fin.all()
                parent = torch.where(done, ident, parent)
                scores = torch.where(done, scores, best)
                gat = (base + parent).reshape(BK)
                for a in kv:
                    a.copy_(a.index_select(0, gat))
                kmask = kmask.index_select(0, gat)
                hist = torch.take_along_dim(hist, parent[:, :, None], dim=1)
                fin = torch.gather(fin, 1, parent)
                tok = torch.where(fin, torch.full_like(ntok, pad), ntok)
                hist[:, :, t + 1] = tok
                if eos is not None:
                    fin = fin | (ntok == eos)
            norm = scores / _length_norm((hist != pad).sum(dim=2), lp_exp)
            pick = torch.argmax(norm, dim=1)                     # [B]
            out = torch.take_along_dim(hist, pick[:, None, None], dim=1)
            return out[:, 0], torch.gather(norm, 1, pick[:, None])[:, 0]
        return raw

    def _generate_beam_eager(self, ids, mask, cfg):
        """Eager beam search (no cache protocol; the reference's
        ``_generate_beam_eager``): beams as rows, the whole prefix
        recomputed every step, starting from beam scores [0, NEG, ...];
        step t writes column t and the loop stops once every beam has
        finished. A padded batch runs row by row."""
        if (mask == 0).any():
            outs, scores = [], []
            for b in range(ids.shape[0]):
                row = ids[b][mask[b].astype(bool)][None, :]
                o, s = self._generate_beam_eager(
                    row, np.ones_like(row, dtype=np.int32), cfg)
                outs.append(o[0])
                scores.append(s[0])
            return np.stack(outs), np.asarray(scores, np.float32)
        return self._generate_beam_eager_batch(ids, cfg)

    @torch.no_grad()
    def _generate_beam_eager_batch(self, ids, cfg):
        B = ids.shape[0]
        K = int(cfg.num_beams)
        N = int(cfg.max_new_tokens)
        eos, pad = cfg.eos_token_id, cfg.pad_token_id
        vocab = self.config.vocab_size
        dev = next(iter(self.parameters())).device
        cur = _repeat_rows(torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                           device=dev), K)    # [B*K, S+t]
        scores = torch.full((B, K), _NEG, device=dev)
        scores[:, 0] = 0.0
        fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
        hist = torch.full((B, K, N), pad, dtype=torch.int32, device=dev)
        base = (torch.arange(B, device=dev) * K)[:, None]
        for t in range(N):
            out = self.forward(cur)
            lg = (out[0] if isinstance(out, tuple) else out)[:, -1, :]
            logp = torch.log_softmax(lg.float(), dim=-1).reshape(B, K, vocab)
            if eos is not None and t < cfg.min_new_tokens:
                logp[:, :, eos] = _NEG
            scores, parent, ntok = _beam_select(scores, fin, logp, pad)
            gat = (base + parent).reshape(-1)
            cur = cur.index_select(0, gat)
            hist = torch.take_along_dim(hist, parent[:, :, None], dim=1)
            fin = torch.gather(fin, 1, parent)
            emit = torch.where(fin, torch.full_like(ntok, pad), ntok)
            hist[:, :, t] = emit
            if eos is not None:
                fin = fin | (ntok == eos)
            cur = torch.cat([cur, emit.reshape(-1, 1).long()], dim=1)
            if bool(fin.all()):
                break
        # the ranking on the host, in float64 as the reference's numpy
        hist = hist.cpu().numpy()
        lens = (hist != pad).sum(axis=2)
        norm = scores.cpu().numpy() / (((5.0 + np.maximum(lens, 1)) / 6.0)
                                       ** float(cfg.length_penalty))
        best = np.argmax(norm, axis=1)
        out = np.take_along_axis(hist, best[:, None, None], axis=1)[:, 0]
        sc = np.take_along_axis(norm, best[:, None], axis=1)[:, 0]
        return out.astype(np.int32), sc.astype(np.float32)

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
        dev = next(iter(self.parameters())).device
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
