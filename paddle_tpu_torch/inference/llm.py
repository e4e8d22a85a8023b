"""Batched and speculative LLM predictors (counterpart of
``paddle_tpu/inference/__init__.py`` ``LLMPredictor`` and
``SpeculativePredictor``).

``LLMPredictor`` left-pads ragged prompts to a power-of-two bucket (from
8), splits them into micro-batches of ``max_batch_size`` (idle rows get a
one-token dummy prompt), runs ``model.generate`` (the static-cache route)
and strips eos and the pad tail. ``quant_type`` rounds every 2-D
projection weight through weight-only quantization (``nn.quant``) in
place. ``SpeculativePredictor`` is greedy draft-model speculation: the
draft proposes ``gamma`` tokens, one target forward verifies them all,
and the output equals the target's plain greedy decode token for token.
Both run on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.layers_common import Embedding
from ..nn.quant import weight_dequantize, weight_quantize

__all__ = ["LLMPredictor", "SpeculativePredictor"]

_QUANT_ALGOS = {"int8": "weight_only_int8", "int4": "weight_only_int4",
                "weight_only_int8": "weight_only_int8",
                "weight_only_int4": "weight_only_int4"}


class LLMPredictor:
    """Batched autoregressive serving over ``model.generate``: prompts are
    lists of token ids; ``generate_defaults`` (``seed``,
    ``decode_strategy``, ...) apply to every call unless a call names
    them again."""

    def __init__(self, model, max_batch_size=8, pad_token_id=0,
                 eos_token_id=None, quant_type=None, **generate_defaults):
        self.model = model
        self.max_batch_size = max_batch_size
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.generate_defaults = generate_defaults
        model.eval()
        if quant_type is not None:
            self._apply_weight_only(quant_type)

    @torch.no_grad()
    def _apply_weight_only(self, quant_type):
        """Round every 2-D projection weight (embeddings excluded: they
        would quantize along the wrong axis) through ``weight_quantize`` /
        ``weight_dequantize``, written back with ``copy_`` so every
        weight keeps its address. ``nn.Linear`` holds [out, in]; the
        quantizer takes Paddle's [in, out], so the weight goes across
        transposed and comes back with int4's pad row stripped."""
        algo = _QUANT_ALGOS.get(quant_type)
        if algo is None:
            raise ValueError(f"unsupported quant_type {quant_type!r}")
        for layer in self.model.modules():
            w = getattr(layer, "weight", None)
            if (not isinstance(w, torch.Tensor) or w.dim() != 2
                    or isinstance(layer, (nn.Embedding, Embedding))):
                continue
            w_in_out = w.t() if isinstance(layer, nn.Linear) else w
            qw, sc = weight_quantize(w_in_out, algo=algo)
            deq = weight_dequantize(qw, sc, algo=algo)[:w_in_out.shape[0]]
            if isinstance(layer, nn.Linear):
                deq = deq.t()
            w.copy_(deq.to(w.dtype))

    @staticmethod
    def _bucket(n):
        b = 8
        while b < n:
            b *= 2
        return b

    def generate(self, prompts, max_new_tokens=32, **kwargs):
        """prompts: List[List[int]] -> List[List[int]] (new tokens only,
        eos and what follows it stripped)."""
        opts = dict(self.generate_defaults)
        opts.update(kwargs)
        results = []
        for i in range(0, len(prompts), self.max_batch_size):
            chunk = prompts[i:i + self.max_batch_size]
            results.extend(self._run_chunk(chunk, max_new_tokens, opts))
        return results

    def _run_chunk(self, chunk, max_new_tokens, opts):
        n = len(chunk)
        bs = self.max_batch_size
        slen = self._bucket(max(len(p) for p in chunk))
        ids = np.full((bs, slen), self.pad_token_id, np.int32)
        mask = np.zeros((bs, slen), np.int32)
        for r, p in enumerate(chunk):
            ids[r, slen - len(p):] = p       # left padding
            mask[r, slen - len(p):] = 1
        if n < bs:          # idle rows: a one-token dummy prompt
            ids[n:, -1] = self.pad_token_id
            mask[n:, -1] = 1
        call = dict(max_new_tokens=max_new_tokens,
                    eos_token_id=self.eos_token_id,
                    pad_token_id=self.pad_token_id)
        call.update(opts)   # per-call and constructor kwargs win
        eos = call["eos_token_id"]
        out, _ = self.model.generate(ids, attention_mask=mask, **call)
        out = out.numpy()
        decoded = []
        for r in range(n):
            toks = out[r].tolist()
            if eos is not None and eos in toks:
                # cutting at eos also drops the pad tail a finished row
                # emits; rows that never finished hold real tokens only
                toks = toks[:toks.index(eos)]
            decoded.append(toks)
        return decoded


class SpeculativePredictor:
    """Greedy speculative decoding with a draft model: ``gamma`` draft
    tokens, verified by ONE target forward, accept the longest matching
    prefix plus the target's own next token. The output equals the
    target's plain greedy decode; ``stats`` counts ``target_calls``,
    ``accepted`` and ``proposed``."""

    def __init__(self, model, draft_model, gamma=4, eos_token_id=None):
        self.model = model
        self.draft = draft_model
        self.gamma = int(gamma)
        self.eos_token_id = eos_token_id
        model.eval()
        draft_model.eval()
        self.stats = {"target_calls": 0, "accepted": 0, "proposed": 0}

    @staticmethod
    @torch.no_grad()
    def _greedy_next(model, ids_np, last_only=False):
        """argmax of the logits: [B, S] ints, or [B] at the last position
        only (a draft step needs no more on the host)."""
        dev = next(iter(model.parameters())).device
        out = model(torch.as_tensor(np.asarray(ids_np), dtype=torch.long,
                                    device=dev))
        logits = out[0] if isinstance(out, tuple) else out
        if last_only:
            logits = logits[:, -1]
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def generate(self, prompt, max_new_tokens=32):
        """Single-sequence greedy speculative decode: List[int] ->
        List[int] (new tokens)."""
        cur = list(prompt)
        new = []
        while len(new) < max_new_tokens:
            g = min(self.gamma, max_new_tokens - len(new))
            d_cur = list(cur)
            proposal = []
            for _ in range(g):
                nxt = int(self._greedy_next(self.draft, [d_cur],
                                            last_only=True)[0])
                proposal.append(nxt)
                d_cur.append(nxt)
            tgt = self._greedy_next(self.model, [cur + proposal])[0]
            self.stats["target_calls"] += 1
            self.stats["proposed"] += g
            base = len(cur) - 1   # tgt[base]: the target's next after cur
            accepted = 0
            while (accepted < g
                   and proposal[accepted] == int(tgt[base + accepted])):
                accepted += 1
            self.stats["accepted"] += accepted
            emit = proposal[:accepted] + [int(tgt[base + accepted])]
            for t in emit:
                if len(new) >= max_new_tokens:
                    break
                new.append(t)
                cur.append(t)
                if self.eos_token_id is not None and t == self.eos_token_id:
                    return new
        return new
