#!/usr/bin/env python3
"""The two eager host-bound paths that every module call of a model
passes through, timed in two checkouts on one GPU in one call: serve
run 1's eager decode tokens/s and the BERT-base fine-tune step median.

    python3 tools/layer_ab.py --parent DIR [--order PCCP] [--seed 0] \
        [--out FILE]

Each letter of ``--order`` is one process (P: the checkout in ``DIR``, C:
this one), run in turn so that the host's drift falls on both sides.
A process imports ``paddle_tpu_torch`` and ``chip_smoke`` from its
checkout, builds that checkout's kernels, and measures:

- serve run 1 of ``chip_smoke.py`` (Llama-2-7B widths, 8 of 32 layers,
  bf16, random weights from ``--seed``; its eight prompts through
  ``ContinuousBatchingPredictor`` with block-table decode), once to warm
  up and then three times on fresh predictors: the decode tokens/s
  outside monolithic prefill that ``chip_smoke.serve_run`` reports;
- the BERT-base fine-tune of ``examples/bert_finetune.py`` (16 x 128,
  row lengths 32-128, 30 steps): the median step time of steps 2-30.

Prints one JSON line per process and, at the end, the medians of each
side with the card's name and power limit; writes all to FILE. Needs one
CUDA device and nvcc; imports nothing of JAX.
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
SERVE_REPS = 3


def child(tree, seed):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.examples import bert_finetune as ex
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    build_s = time.perf_counter() - t0
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=8, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 2)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    shared = toks(8 * 16 + 5)
    prompts = [toks(512), toks(48), shared, toks(32), toks(300),
               shared + toks(91), toks(200), toks(130)]
    max_new = [64, 40, 48, 32, 56, 48, 36, 60]
    serve = []
    for rep in range(SERVE_REPS + 1):
        res = cs.serve_run(torch, dev, model, cfg, prompts, max_new, card,
                           f"A/B run 1 ({rep})", cs.RUN1_KERNELS, cs.RUN1)
        res.pop("cb")
        if rep:
            serve.append(res["tok_s"])
    del model
    cs.free_card(torch)
    ft = ex.main(["--model", "bert", "--steps", "30", "--batch", "16",
                  "--seq", "128", "--min-len", "32", "--device", str(dev)])
    step_ms = [s * 1e3 for s in ft["step_s"][1:]]
    return {"tree": tree, "build_s": build_s, "serve_tok_s": serve,
            "finetune_step_ms_median": statistics.median(step_ms)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other checkout")
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print("AB " + json.dumps(child(args.child, args.seed)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("layer_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = {"P": os.path.abspath(args.parent), "C": HERE}
    runs = []
    for side in args.order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             trees[side], "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=900)
        line = next((x for x in proc.stdout.splitlines()
                     if x.startswith("AB ")), None)
        if proc.returncode or line is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = dict(json.loads(line[3:]), side=side)
        print(json.dumps(res), flush=True)
        runs.append(res)
    summary = {}
    for side in "PC":
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {
            "serve_tok_s_median": statistics.median(
                x for r in mine for x in r["serve_tok_s"]),
            "finetune_step_ms": [r["finetune_step_ms_median"]
                                 for r in mine]}
    print(json.dumps({"card": smi, "order": args.order, **summary}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "summary": summary}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
