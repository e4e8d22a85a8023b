#!/usr/bin/env python3
"""Replayed decode rate of ``generate()``'s static route, for the package
of a given checkout, so that two checkouts can be compared end to end on
one GPU in one run (parent, change, change, parent: one process each).

    python3 tools/static_decode_ab.py [--repo DIR] [--runs 5]

``--repo`` names the checkout whose ``paddle_tpu_torch`` is imported
(default: this one); its kernels build into that checkout's ``_build/``.
Random weights from fixed seeds, bf16, the traffic of ``chip_smoke.py``'s
GPT and inference-API phases:

- GPT-2 XL (all 48 layers) greedy and beam search (4 beams, length
  penalty 0.6) over 4 left-padded prompts of 17-300 tokens, 32 new;
- Llama-2-7B (32 layers) through ``LLMPredictor`` (max_batch_size 8)
  over 8 prompts of 17-300 tokens, 32 new, greedy.

Each signature is captured by a first call; then the median wall time
of ``--runs`` replayed calls with 32 new tokens, less that of the
prefill-only call (1 new token), gives decode tokens/s (output tokens).
Prints the card and one JSON object {route: tok/s}. Needs one CUDA
device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = (300, 17, 256, 40)
LLAMA_LENS = (300, 17, 256, 40, 128, 200, 64, 90)
NEW = 32


def left_padded(torch, vocab, lens, seed):
    """[B, max(lens)] ids and mask, padding on the left."""
    import numpy as np
    gen = torch.Generator().manual_seed(seed)
    s = max(lens)
    ids = np.zeros((len(lens), s), np.int64)
    mask = np.zeros((len(lens), s), np.int32)
    for r, n in enumerate(lens):
        ids[r, s - n:] = torch.randint(1, vocab, (n,), generator=gen).numpy()
        mask[r, s - n:] = 1
    return ids, mask


def decode_rate(torch, call, rows, runs):
    """Output tokens a second of ``call(n)`` replayed, outside the
    prefill: rows * (NEW - 1) over the median of call(NEW) less that of
    call(1)."""
    def wall(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    for n in (1, NEW):      # the captures
        call(n)
    pre = statistics.median(wall(1) for _ in range(runs))
    full = statistics.median(wall(NEW) for _ in range(runs))
    return rows * (NEW - 1) / (full - pre)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("static_decode_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.repo))
    from paddle_tpu_torch.inference import LLMPredictor
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; package: {os.path.abspath(args.repo)}", flush=True)
    _build.build(_build.SOURCES)
    dev = torch.device("cuda")
    out = {}
    cfg = GPTConfig.gpt2_xl(dtype="bfloat16")
    model = GPTForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(21)).eval()
    ids, mask = left_padded(torch, cfg.vocab_size, LENS, 22)
    for name, kw in (("gpt2_xl_greedy", {}),
                     ("gpt2_xl_beam", dict(decode_strategy="beam_search",
                                           num_beams=4,
                                           length_penalty=0.6))):
        out[name] = decode_rate(
            torch, lambda n: model.generate(ids, attention_mask=mask,
                                            max_new_tokens=n, **kw),
            len(LENS), args.runs)
        print(f"{name}: {out[name]:.1f} tok/s", flush=True)
    model._gen_cache.clear()
    del model
    torch.cuda.empty_cache()
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(12))
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in LLAMA_LENS]
    pred = LLMPredictor(model, max_batch_size=8)
    out["llama2_7b_llm_predictor"] = decode_rate(
        torch, lambda n: pred.generate(prompts, n), len(prompts), args.runs)
    print(f"llama2_7b_llm_predictor: {out['llama2_7b_llm_predictor']:.1f} "
          "tok/s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
