#!/usr/bin/env python3
"""Greedy tokens of serve run KV with this checkout's attention kernels
and with another checkout's, in one process on one GPU.

    python3 tools/serve_kv_ab.py --parent DIR [--layers 32] [--seed 0] \
        [--out FILE]

The traffic of ``chip_smoke.py``'s serve run KV: its serve model
(Llama-2-7B widths, bf16, random weights from ``--seed``), run 1's eight
prompts and two lookup prompts (``chip_smoke.lookup_prompt``), served by
``ContinuousBatchingPredictor`` over a float32 KV pool with block-table
decode, chunked prefill (256) and 4 drafts (``chip_smoke.RUN_KV``): the
prefix cache's suffix prefill (``flash_fwd``), the chunked mixed steps
and the verify spans (``paged_varq``) run a bf16 q over f32 pages. The
requests are served twice: with this checkout's libraries, then with the
``flash_fwd`` and ``paged_varq`` libraries built from ``DIR``'s
``paddle_tpu_torch/csrc`` loaded in their place (the same C entries; the
rest of the package is this checkout's). Where a request's tokens part,
the top-two margin of the logits there (a forward of the prompt and the
common tokens without a cache, this checkout's kernels) says whether it is
a near tie that rounding decides. Prints both runs' statuses, each
request's first differing position with that margin, and the decode
tokens/s of each; writes the tokens to FILE. Needs one CUDA device and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWAPPED = ("flash_fwd", "paged_varq")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose flash_fwd and paged_varq "
                         "libraries serve the second run")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import chip_smoke as S
    import torch
    if not torch.cuda.is_available():
        print("serve_kv_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    _build.build(_build.SOURCES)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=args.layers,
                                dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(args.seed))
    gen = torch.Generator().manual_seed(args.seed + 2)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    # run 1's prompts and lengths, as chip_smoke.serve_phase draws them
    shared = toks(8 * 16 + 5)
    prompts = [toks(512), toks(48), shared, toks(32), toks(300),
               shared + toks(91), toks(200), toks(130)]
    max_new = [64, 40, 48, 32, 56, 48, 36, 60]
    prompts += [S.lookup_prompt(torch, model, dev, toks, 64, 5, 16, **S.GEOM,
                                **dict(S.RUN2, spec_draft_tokens=0))
                for _ in range(2)]
    max_new += [64, 64]

    def serve(label):
        cb = ContinuousBatchingPredictor(model, device=dev, **S.GEOM,
                                         **S.RUN_KV)
        cb.generate(prompts[:1], max_new_tokens=2)      # warm: no build
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = cb.generate(prompts, max_new_tokens=max_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sum(len(o) for o in outs)
        print(f"{label}: statuses {cb.last_status}; {n} tokens in "
              f"{wall:.2f} s ({n / wall:.1f} tok/s)", flush=True)
        return outs

    mine = serve("this checkout's kernels")
    # the parent's libraries in place of this checkout's two
    src = _build.SRC_DIR
    _build.SRC_DIR = Path(os.path.abspath(args.parent)) / \
        "paddle_tpu_torch" / "csrc"
    _build.build(SWAPPED)
    with _build._lock:
        for name in SWAPPED:
            _build._libs.pop(name, None)
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.kernels import paged_attention as P
    A.load("flash_fwd", A._SIGNATURES)
    P.load("paged_varq", P._SIGNATURES["paged_varq"])
    theirs = serve(f"{args.parent}'s flash_fwd and paged_varq")
    _build.SRC_DIR = src
    with _build._lock:
        for name in SWAPPED:
            _build._libs.pop(name, None)
    first = []
    for r, (a, b) in enumerate(zip(mine, theirs)):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        first.append(i)
        if i is None:
            continue
        with torch.no_grad():
            lg = model(torch.tensor([prompts[r] + a[:i]], device=dev))[
                0, -1].float()
        top = lg.topk(2).values
        print(f"request {r}: tokens part at {i} ({a[i]} vs {b[i]}); top-two "
              f"logit margin there {float(top[0] - top[1]):.3e} (top "
              f"{float(top[0]):.3f}, logit std {float(lg.std()):.3f})",
              flush=True)
    print(f"first differing position per request {first}; "
          f"{sum(i is None for i in first)} of {len(first)} equal",
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "mine": mine, "theirs": theirs,
                       "first": first}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
