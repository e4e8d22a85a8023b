#!/usr/bin/env python3
"""Median device times of the port's CUDA kernels, for the package of a
given checkout, so that two checkouts can be compared on one GPU in one
run.

    python3 tools/kernel_times.py [--repo DIR] [--iters 24]

``--repo`` names the checkout whose ``paddle_tpu_torch`` is imported
(default: this one); its kernels build into that checkout's ``_build/``.
Times (``chip_smoke.time_ms`` of this checkout: CUDA events around each
call behind a sleep kernel, inputs rotating past the 50 MB L2), at the
shapes ``chip_smoke.py`` uses:

- ``flash_fwd`` bf16 and f32 at q[4, 512, 32, 128] causal + a prefill
  mask, bf16 at q[2, 2048, 32, 128] causal, f32 at BERT's
  q[16, 128, 12, 64] with a key-padding mask;
- ``flash_bwd_dkdv`` and ``flash_bwd_dq`` bf16 at q[2, 2048, 32, 128]
  causal, f32 at BERT's shape; beside the f32 ones (the BERT-base
  fine-tune's instances), SDPA in f32 on the same inputs (the additive
  key mask; its forward, and its backward giving dQ, dK and dV together,
  behind a longer sleep: its host enqueue outlasts the default one) and
  each kernel's bound (bytes over 3.35 TB/s or operations over the peak,
  as ``chip_smoke.bound``: the f32 peak for the forward, on the FMA
  units; the 16-bit tensor-core peak for the backward pair, whose f32
  operands enter the tensor cores as bf16 hi + lo parts);
- ``paged_decode`` bf16 and f32 at q[4, 32, 128], contexts 557 / 300 /
  97 / 1, page 16, 64 pages per sequence, and ``ragged_decode`` bf16 on
  the same inputs through the serving loop's meta (G = 256);
- ``paged_varq`` bf16 at the mixed shape q[4, 256, 32, 128], q_lens 256 /
  1 / 1 / 97, kv_lens 512 / 301 / 98 / 97, and the verify shape
  q[4, 5, 32, 128], q_lens 5 / 5 / 5 / 5, kv_lens 561 / 305 / 101 / 5;
- ``rms_norm`` bf16 at x[2048, 4096] and ``layer_norm`` bf16 at
  x[2048, 768] (Triton).

Prints the card, one JSON object {kernel and shape: ms}, then one
{"bounds": {kernel and shape: [ms, "bytes" or "operations"]}}. Needs one
CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--iters", type=int, default=24)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import chip_smoke as S
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.kernels import norm as N
    from paddle_tpu_torch.kernels import paged_attention as P
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; package: {os.path.dirname(A.__file__)}",
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def med(name, fn, sets):
        times[name] = S.time_ms(torch, fn, sets, iters=args.iters)["median"]

    def rnd(shape, dt):
        return torch.randn(*shape, device=dev, generator=g).to(dt)

    short = {torch.bfloat16: "bf16", torch.float32: "f32"}
    lens = torch.tensor([512, 384, 200, 64], device=dev)
    mask, _ = S.prefill_mask(torch, dev, lens, 512)
    for dt in (torch.bfloat16, torch.float32):
        sets = [tuple(rnd((4, 512, 32, 128), dt) for _ in range(3))
                for _ in range(2)]
        med(f"flash_fwd {short[dt]} q[4, 512, 32, 128] causal+mask",
            lambda a, b, c: A.flash_attention_kernel(a, b, c, 128 ** -0.5,
                                                     True, mask), sets)
    train = [tuple(rnd((2, 2048, 32, 128), torch.bfloat16) for _ in range(4))
             for _ in range(2)]
    train = [(q, k, v, do, *A.flash_attention_kernel(q, k, v, 128 ** -0.5,
                                                     True))
             for q, k, v, do in train]
    train = [(q, k, v, do, lse, A.bwd_delta(out, do))
             for q, k, v, do, out, lse in train]
    med("flash_fwd bf16 q[2, 2048, 32, 128] causal",
        lambda q, k, v, *_: A.flash_attention_kernel(q, k, v, 128 ** -0.5,
                                                     True), train)
    med("flash_bwd_dkdv bf16 q[2, 2048, 32, 128] causal",
        lambda *a: A.flash_bwd_dkdv_kernel(*a, 128 ** -0.5, True), train)
    med("flash_bwd_dq bf16 q[2, 2048, 32, 128] causal",
        lambda *a: A.flash_bwd_dq_kernel(*a, 128 ** -0.5, True), train)
    key = S.bert_key_mask(torch, dev)
    bert = [tuple(rnd((16, 128, 12, 64), torch.float32) for _ in range(4))
            for _ in range(2)]
    bert = [(q, k, v, do, *A.flash_attention_kernel(q, k, v, 0.125, False,
                                                    key))
            for q, k, v, do in bert]
    bert = [(q, k, v, do, lse, A.bwd_delta(out, do))
            for q, k, v, do, out, lse in bert]
    med("flash_fwd f32 q[16, 128, 12, 64] key mask",
        lambda q, k, v, *_: A.flash_attention_kernel(q, k, v, 0.125, False,
                                                     key), bert)
    med("flash_bwd_dkdv f32 q[16, 128, 12, 64] key mask",
        lambda *a: A.flash_bwd_dkdv_kernel(*a, 0.125, False, key), bert)
    med("flash_bwd_dq f32 q[16, 128, 12, 64] key mask",
        lambda *a: A.flash_bwd_dq_kernel(*a, 0.125, False, key), bert)
    # one PyTorch call of each: SDPA on the same f32 inputs and mask, and
    # its backward (dQ, dK and dV together)
    F = torch.nn.functional
    med("sdpa f32 q[16, 128, 12, 64] key mask",
        lambda q, k, v, *_: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=key, scale=0.125), bert)
    times["sdpa backward f32 q[16, 128, 12, 64] key mask (dQ, dK, dV)"] = \
        S.sdpa_bwd_times(torch, bert, key, iters=args.iters)["median"]
    # bounds of the f32 BERT rows: the (query, key) pairs the mask keeps
    # per head; the forward does 2 products (4 d operations a pair), dK/dV
    # 4 and dQ 3 (as chip_smoke's backward rows), the backward's at the
    # 16-bit tensor-core peak; each input read once, each output written
    # once
    b_, s_, h_, d_ = 16, 128, 12, 64
    pairs = int((key[:, 0, 0] > S.NEG / 2).sum()) * s_ * h_
    t_b = b_ * s_ * h_ * d_ * 4                  # one f32 [B, S, H, D]
    rows = b_ * h_ * s_ * 4                      # lse or delta
    mb = key.numel() * 4
    bounds = {
        "flash_fwd f32 q[16, 128, 12, 64] key mask":
            S.bound(4 * t_b + mb + rows, 4 * d_ * pairs, "float32"),
        "flash_bwd_dkdv f32 q[16, 128, 12, 64] key mask":
            S.bound(2 * t_b + 4 * t_b + 2 * rows + mb, 8 * d_ * pairs,
                    "bfloat16"),
        "flash_bwd_dq f32 q[16, 128, 12, 64] key mask":
            S.bound(3 * t_b + 2 * t_b + 2 * rows + mb, 6 * d_ * pairs,
                    "bfloat16")}
    ctx = torch.tensor([557, 300, 97, 1], dtype=torch.int32, device=dev)
    tables = torch.randperm(257, device=dev, generator=g)[:256].reshape(
        4, 64).to(torch.int32).contiguous()
    for dt in (torch.float32, torch.bfloat16):   # bf16 pages kept below
        q = rnd((4, 32, 128), dt)
        pages = [tuple(rnd((257, 16, 32, 128), dt) for _ in range(2))
                 for _ in range(4)]
        med(f"paged_decode {short[dt]} q[4, 32, 128] ctx 557/300/97/1",
            lambda kp, vp: P.paged_attention_kernel(q, kp, vp, tables, ctx,
                                                    128 ** -0.5), pages)
    meta = S._builder_meta(torch, dev, tables, ctx, 16)
    med("ragged_decode bf16 q[4, 32, 128] ctx 557/300/97/1 G=256",
        lambda kp, vp: P.paged_attention_ragged_kernel(q, kp, vp, ctx, meta,
                                                       128 ** -0.5), pages)
    for qb, q_lens, kv_lens in ((256, [256, 1, 1, 97], [512, 301, 98, 97]),
                                (5, [5, 5, 5, 5], [561, 305, 101, 5])):
        q = rnd((4, qb, 32, 128), torch.bfloat16)
        ql, kl = (torch.tensor(x, dtype=torch.int32, device=dev)
                  for x in (q_lens, kv_lens))
        meta = S._builder_meta(torch, dev, tables, kl, 16)
        med(f"paged_varq bf16 q[4, {qb}, 32, 128] kv_lens "
            f"{'/'.join(map(str, kv_lens))}",
            lambda kp, vp: P.paged_attention_varq_kernel(
                q, kp, vp, kl, ql, 128 ** -0.5, meta=meta), pages)
    for name, n, fn in (("rms_norm", 4096, lambda x, w, b: N.rms_norm_kernel(
                            x, w, 1e-6)),
                        ("layer_norm", 768, lambda x, w, b:
                         N.layer_norm_kernel(x, w, b, 1e-12))):
        # 8 row blocks of 2048 rows: 134 MB at 4096 features
        sets = [(rnd((2048, n), torch.bfloat16), rnd((n,), torch.bfloat16),
                 rnd((n,), torch.bfloat16)) for _ in range(8)]
        med(f"{name} bf16 x[2048, {n}]", fn, sets)
    print(json.dumps(times), flush=True)
    print(json.dumps({"bounds": bounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
