#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py [--layers 32] [--seed 0]

Needs one NVIDIA GPU, ``nvcc`` and ``triton``; imports nothing of JAX.

1. Build: compiles every CUDA source of the port from the checkout (one
   nvcc per source, all started together).
2. Kernels: each hand-written kernel (RMSNorm and LayerNorm in Triton;
   flash-attention forward and backward (dK/dV, dQ), paged decode,
   ragged decode and the variable-query span kernel in CUDA) against its
   plain PyTorch version at the Llama-2-7B serving and training shapes in
   bf16, once in f32 and in a GQA case (H=32, Hkv=8); the backward also
   at head_dim 64 and with Sq != Sk, a key-padding mask and kv_lens;
   LayerNorm at BERT-base's x[2048, 768] in f32 and bf16; the three flash
   kernels with attention dropout 0.1 at BERT-base's q[16, 128, 12, 64]
   with a key-padding mask in f32 and bf16 (the keep rate within
   binomial bounds of 0.9); with the tolerances below. Prints each
   kernel's median device time, its bound (bytes over 3.35 TB/s or
   operations over the card's peak for their type), the plain version's
   time and the one-call PyTorch equivalent's time where one exists, and
   the flash kernels' times with and without dropout at the BERT shape.
   Also times the forward at the training shape q[2, 2048, 32, 128] bf16
   causal (with lse, beside causal SDPA and its operations bound), paged
   decode at contexts up to pps * page = 1024 (beside ragged decode on
   the same inputs, held to its plain version there too), the
   variable-query kernel at the speculative verify shape q[4, 5, 32, 128]
   (5-row spans over 561 / 305 / 101 / 5 keys), the forward at the
   static route's decode shape (q[8, 1, 32, 128] against 544 cached
   keys under a bool padding mask, beside SDPA with the same mask), and
   the f32 instances of both decode kernels at their bf16 shapes. A second bf16 launch of the
   backward, ragged-decode and variable-query kernels must equal the
   first bit for bit. Then the fused optimizer's two CUDA kernels
   (``fused_update``, ``grad_sq_norm``) against their plain versions for
   one AdamW step with a global-norm clip, at one Llama-2-7B layer's
   tensors plus the embedding in bf16 with f32 master weights and at
   BERT-base's 201 tensors in f32, a second kernel step from an equal
   copy bit for bit equal; each timed beside its bound, its plain version
   and ``torch._fused_adamw_`` / ``torch._foreach_norm`` on the same
   tensors. Then the sampling draw kernel's two entry points
   (``csrc/sampling.cu``): ``categorical_rows`` at serve run 3's decode
   shape logits[4, 32000] f32 and at its verify shape [20, 32000] with
   offsets, tokens equal to the plain version's on every row (a row that
   differs prints its top-2 margin in f32 ulps), and ``uniform64_rows``
   bit for bit; 20,000 draws over a 16-way distribution pass a
   chi-square test at p > 1e-3; timed beside the bound, the plain version
   and ``torch.multinomial(softmax(l))`` (another stream). Then the f16
   and mixed-dtype instances (``dtype_phase``) at the bf16 rows' shapes,
   each against its plain version within ``TOL["float16"]`` or, for q
   and K/V (pages) of two dtypes, the narrower dtype's tolerance, a
   second launch bitwise the first, timed beside its bound, its plain
   version and the one-call PyTorch equivalent (``F.rms_norm``,
   ``F.layer_norm``, SDPA; none for two dtypes): RMSNorm at x[2048,
   4096] and LayerNorm at x[2048, 768] in f16; the flash forward in f16
   at the prefill and static decode shapes and with bf16 q over f32 K/V
   at a suffix-prefill shape (q[1, 128], 384 keys under the suffix's
   mask); paged and ragged decode and the span kernel (both its shapes)
   in f16, with bf16 q over f32 pages and with f32 q over bf16 pages.
   Then GPT-2 XL's two shapes (``gpt_kernel_rows``): LayerNorm at
   x[1200, 1600] bf16 (the 4 x 300-token prefill) and the flash forward
   at the beam route's static decode shape, q[16, 1, 25, 64] against k,
   v[16, 332, 25, 64] bf16 under a bool padding mask, each against its
   plain version, a second launch bitwise the first, timed beside its
   bound, its plain version and ``F.layer_norm`` / SDPA.
3. Full-width f32 checks: a 2-layer model at Llama-2-7B widths gives the
   same prefill logits on the card (kernels) as on the CPU (plain
   versions) and the same greedy tokens through the predictor; the
   chunked + speculative + ragged configuration gives the same greedy
   tokens on the card as the plain configuration on the card, and as
   itself on the CPU (chunking and speculation are lossless), with drafts
   both accepted and rejected (so the verify step commits drafts and
   rolls back rejected positions on the card); a weight change in place
   between two serves flushes the prefix cache (no hit in the second
   serve, a fresh predictor's tokens); 3 AdamW TrainSteps of
   the same 2-layer model give the CPU's losses, step-1 gradients,
   weight changes and moments; and BERT-base (all 12 layers) gives the
   CPU's eval logits within 1e-3 and, over 3 eager AdamW steps of the
   fine-tune example's loop with attention dropout 0.1 (the same host
   seeds) and hidden dropout 0, its losses within rtol 1e-4 and step-1
   gradients within 1e-3 of each tensor's largest. Then the KV-dtype
   gates at 2 layers and full width (``kv_dtype_gates``): an f32 model
   over a bf16 KV pool, block-table (with a suffix prefill) and ragged +
   chunked (64) + speculative (4) with a rejected draft, gives the CPU's
   greedy tokens up to each request's first difference, which passes
   only where the CPU's top-two margin there is within
   ``PAGES_BF16_TOL`` (a near tie that the pages' bf16 rounding decides;
   each printed), and the CPU's stats where no token differs; an f16
   model (the same weights cast) gives the CPU's prefill logits within
   ``LOGIT_TOL16`` and its block-table greedy tokens as above within
   ``LOGIT_TOL16``, and a lookup prompt served alone sees drafts both
   accepted and rejected over f16 pages (``draft_check``).
4. Serve: Llama-2-7B widths in bf16 with random weights drawn on the
   card from a seeded torch.Generator. Run 1: 8 requests through
   ContinuousBatchingPredictor (max_batch_size=4, block-table decode,
   two requests sharing a cached prefix so suffix prefill and
   copy-on-write run). Run 2: the same 8 plus two 320-token prompts that
   repeat a 64-token segment, the last copy led by the model's own
   continuation (``lookup_prompt``), with ragged decode, chunked prefill
   (256) and speculative decoding (4 drafts). Run 3: run 2's configuration
   and ten prompts with ``sampling_enabled=True``, 3 greedy and 7 sampled
   requests (``RUN3_MIX``); (a) the same run again gives the same tokens,
   (b) all ten greedy on that predictor give run 2's tokens, (c) another
   seed for one sampled request changes its tokens, (d) sampled requests
   were admitted, a mixed step paused a sampled slot and sampled slots
   drafted, (e) both draw kernels launched. Every request must finish 'ok'
   and every kernel a run drives must have launched in that run. Prints
   TTFT, tokens/s and peak memory of each, profiles a pass of runs 1-2,
   and counts the device activities of a greedy and a sampled decode
   tick. Then the serving front end on the same model and run 1's
   configuration: (a) run 1's requests through ``generate()``, through
   ``generate_stream`` and streamed with the decode watchdog armed at
   30 s, on fresh predictors in the order g s w s g: the concatenated
   spans equal to run 1's tokens bit for bit, every end event 'ok', the
   first event before half the stream's wall time, no trip, and each
   kernel launched as often as in run 1 (time to first event and decode
   tokens/s of the three side by side); (b) 4 interactive and 12
   batch requests (32-300 prompt tokens, 16-32 new) with weights 4:1
   into a queue bounded at 8, newest shed: exactly 8 batch requests
   shed, the rest 'ok'; (c) ``deadline_s=0`` ends 'deadline' with no
   token, a request cancelled after its 4th token ends 'cancelled' with
   a prefix of its run 1 tokens, a stream closed after 3 events cancels
   every request, and no slot holds a page after any of them; (d)
   ``decode_wedge:sleep=5`` under a 0.5 s watchdog returns within 5 s
   with one trip and every request 'watchdog', the device then
   synchronizes, and the flight recorder's dump at the trip names every
   wedged request's ``serve.request`` span; (e) ``serve_stream`` over an intake of 2 requests a
   poll for 4 polls (run 1's prompts, 16 new tokens each) serves all 8.
   Serve run KV (after the serve phase, on its model): run 2's traffic
   with ``kv_dtype="float32"`` and block-table decode, then run 1's
   prompts 2-6 through ragged decode: every request ok, the pool's bytes
   those of f32 pages, and flash_fwd (the suffix prefill), paged_decode,
   paged_varq and ragged_decode launched with bf16 q over f32 pages
   (``kernels.dtype_launch_counts``).
   Then the inference API on the same model (``infer_phase``): (a)
   ``LLMPredictor`` (max_batch_size 8) over 12 prompts of 17-300 tokens
   (two micro-batches, buckets 512 and 128), 32 new tokens greedy and
   once sampled (temperature 0.8, top-p 0.9, a seed that replays its
   tokens) through ``generate()``'s static-cache route, one CUDA graph
   per signature: each signature's eager first call captures it, and
   three replays equal that call bit for bit (``graph_run``); every row
   gets its tokens, and the ``rms_norm``, ``flash_fwd`` and
   ``categorical_rows`` launches of the eager call and of each replay
   equal the route's count (per call and step 2L + 1, L and, sampled,
   1); then beam search (4 beams, length penalty 0.6) on 4 of the
   prompts (17-300 tokens, 32 new) the same way; prints decode tokens/s
   eager and replayed, prefill ms, capture seconds and peak memory;
   (b) ``SpeculativePredictor`` (gamma 4) with a
   2-layer draft of the same widths and with the target as its own
   draft: target calls, accepted / proposed, tokens/s; (c) ``jit.save``
   of ERNIE-3.0-base (f32 and bf16 at 16 x 128 with a fixed
   ``InputSpec``, f32 with ``[None, 128]``) and of a 2-layer full-width
   bf16 Llama at 256 tokens; a second process (``--infer-child``) that
   imports no model module runs each ``.pt2`` through ``Config`` /
   ``create_predictor``, one CUDA graph per input signature (the ``None``
   batch at batch 16 and 5 is two): the first call (eager, then
   captured) within ``TOL`` of the live model's outputs, three replays
   bitwise the first call, every kernel launched by the first call and by
   each replay as often as in the live forward (``layer_norm`` and
   ``flash_fwd`` for ERNIE, ``rms_norm`` and ``flash_fwd`` for Llama),
   one capture per signature; prints ms a run eager and replayed beside
   the live model's, and the capture seconds; (d) at 2 layers and full width in f32, card against CPU: the
   static route greedy and sampled (seeds, eos, min_new_tokens,
   repetition penalty) and beam search on the static route (with eos and
   min_new_tokens too) and on the eager route over a left-padded batch
   token for token, ``LLMPredictor`` with ``weight_only_int8`` and
   ``weight_only_int4`` (quantized in place, so int4 replays int8's
   graph), and ``SpeculativePredictor`` (a 1-layer draft, and the target
   as its own) equal to plain greedy; and GPT at GPT-2 XL's widths (2
   layers, f32): greedy, sampled and beam on both routes, token for
   token.
5. AOT engine (``paddle_tpu_torch/inference/aot``): two bundles built
   from the serve phase's model (``EngineBuilder``: run 1's block-table
   geometry, and runs 2-3's with sampling enabled; power-of-two prompt
   buckets and the runs' prompts served once, so the shared prompt's
   suffix prefill is recorded), each program captured into a CUDA graph.
   A 2-layer full-width f32 model warm-started on the card gives the CPU
   eager predictor's tokens and stats, and a weight change in place
   flushes its prefix cache as in 3. Then a second process (this
   script with ``--aot-child``, its default kernel build directory empty)
   draws the same weights from the seed, warm-starts from the bundles and
   serves runs 1-3 through replayed graphs: tokens, stats and (runs 1 and
   3) every kernel's launch count, counted by replay, equal this
   process's eager runs; every counted run hits the bundle and misses
   nothing; a sampled decode tick draws once; run 1's requests streamed
   through graphs give the eager stream's tokens with no miss, unarmed
   and with the watchdog armed at 30 s (their tokens/s beside
   ``generate()``'s). Each counted run is held to its telemetry
   (``telemetry_gate``, ``observability`` on as by default): every
   registry counter equal to its ``stats`` twin, completed requests by
   status equal to the statuses, one ended ``serve.request`` span per
   request with its events, the ``aot.bundle_hits`` /
   ``aot.bucket_misses`` series equal to the engine's counters, and
   ``serve.cold_start_seconds`` labelled ``warm``; runs 1 and 2 run
   again with telemetry on, off, off, on (``telemetry_ab``: decode
   tokens/s, TTFT p50 and host microseconds per decode tick, printed,
   not gated), and the process's JSONL sink and Prometheus text are
   counted. A 600-token prompt (bucket
   1024, uncalibrated) misses once, is served with the eager tokens and
   written back, and a second warm start hits it. No nvcc runs in that
   process. Prints, beside eager, each run's decode tokens/s, TTFT p50,
   idle share of a profiled pass, host ops per decode step, device
   activities per decode tick, peak memory (the graph pool included) and
   the capture seconds at warm start. The bundles go to
   ``output/chip_smoke_aot`` and are deleted afterwards. Then serve run
   F16 (``serve_f16_phase``): Llama-2-7B widths and depth in float16
   (random weights from their own seed, the default f16 pool) in run 3's
   configuration and traffic: every request ok, drafts proposed and
   rejected (accepted ones: the 2-layer f16 gate; at 32 layers no lookup
   prompt's draft is accepted, in bf16 either), rms_norm, flash_fwd,
   ragged_decode and paged_varq launched on f16 operands and
   categorical_rows launched; decode tokens/s, TTFT
   p50, peak memory and a profiled pass's idle share. Then BERT-base
   cast to float16, one eval forward of 16 x 128: 25 LayerNorm and 12
   flash launches on f16 operands.
   Then GPT (``gpt_phase``): GPT-2 XL's published widths (hidden 1600,
   25 heads of 64, inner 6400, vocab 50257), all 48 layers, bf16, random
   weights from a seed: greedy, sampled (temperature 0.8, top-p 0.9) and
   beam search (4 beams) over 4 left-padded prompts of 17-300 tokens, 32
   new tokens, through the static route's graphs (eager first call,
   three bitwise replays, launches 2L + 1 ``layer_norm`` and L
   ``flash_fwd`` a forward and one ``categorical_rows`` a sampled step);
   prints decode tokens/s eager and replayed, capture seconds and peak
   memory. Then ``paddle_tpu_torch/examples/llm_serve.py`` on the card
   (it ends ``OK``; its exported program's logits within f32 ``TOL`` of
   the live model's).
6. Fine-tune, through ``paddle_tpu_torch/examples/bert_finetune.py``:
   BERT-base, 30 steps at batch 16 x 128 with row lengths 32-128 through
   ``attention_mask``, every dropout 0.1; then ERNIE-3.0-base for 6
   steps. Every loss finite, and per step 25 LayerNorm launches, 12 of
   each flash kernel and one ``fused_update`` (the eager ``opt.step()``).
   Prints step time, tokens/s, MFU (f32 peak) and peak memory, and
   profiles one step.
7. Train: Llama-2-7B widths in bf16, 8 of 32 layers (AdamW's f32 master
   weights and moments take 16 bytes per parameter: all 32 layers would
   need 108 GB), through ``Trainer`` for 6 steps at batch 2 x 2048 on one
   fixed batch: every loss finite, the last below the first, and each
   kernel launched its per-layer count every step (``fused_update`` and
   ``grad_sq_norm`` once a step, through ``TrainStep``). Prints step time,
   tokens/s, MFU and peak memory, and profiles one step. Then checkpoint
   and resume on a 2-layer hidden-1024 bf16 model: a fresh Trainer
   resumed from the step-4 checkpoint reaches the uninterrupted run's
   step-5 and step-6 losses and, bitwise, its step-6 weights and
   optimizer state. Checkpoints go to ``output/`` in the checkout and
   are deleted afterwards.

The line before the last is the ``kernels`` JSON record; the last line
is ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script then exits non-zero and prints no result. Exits non-zero before
doing anything without a CUDA device or without the package beside it.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor cores
            "float16": 989e12,     # dense fp16 tensor cores
            "float32": 67e12}      # f32 outside the tensor cores
NEG = -1e30
# kernel vs plain version on the card: f32 sums in another order over up
# to 512 keys / 4096 features. bf16 outputs are rounded at other places,
# at most one bf16 ulp apart (2^-7 relative, within rtol); atol holds the
# small outputs of long contexts (|out| ~ 0.05 at 557 keys) to a few
# bf16 ulps of their own size. f16 keeps 3 bits more (an ulp is 2^-10
# relative at most, 2^-11 at the least): the bf16 tolerance over 5, rtol
# 4e-3 (four f16 ulps) and atol 1e-3 (at |out| ~ 0.05, as many f16 ulps
# of its size as bf16's atol holds bf16 ulps). q and K/V (pages) of two
# dtypes: the narrower one's (``pair_tol``)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-3, rtol=2e-2),
       "float16": dict(atol=1e-3, rtol=4e-3)}
# full-width 2-layer f32 prefill logits, card vs CPU
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)


def log(msg):
    print(f"chip_smoke: {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_kernel_ms(torch, prof):
    """{device activity (kernel, copy, memset): (device ms, count)} from
    a profiler trace; host ops are left out so nothing counts twice."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def time_ms(torch, fn, sets, iters=24, warmup=4):
    """Times of one call of fn(*sets[i % len(sets)]), in ms. The input
    sets together exceed the 50 MB L2, so every call reads its inputs
    from device memory, as the bound assumes.

    - "median": median over `iters` calls of the device time between two
      CUDA events around the call; a ~0.6 ms sleep kernel queued ahead
      of each call keeps the device busy while the host enqueues it, so
      host launch cost stays outside the events.
    - "cupti": the CUPTI-traced device time of everything the calls
      launch (torch.profiler), per call — a cross-check.
    - "queue": CUDA events around `iters` back-to-back calls, per call —
      what a caller launching from Python gets, host cost included where
      it exceeds the device time.
    """
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        for i in range(n):
            fn(*sets[i % len(sets)])

    def event():
        return torch.cuda.Event(enable_timing=True)
    run(warmup)
    torch.cuda.synchronize()
    pairs = []
    for i in range(iters):
        torch.cuda._sleep(1_000_000)
        start, end = event(), event()
        start.record()
        fn(*sets[i % len(sets)])
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    median = statistics.median(a.elapsed_time(b) for a, b in pairs)
    start, end = event(), event()
    start.record()
    run(iters)
    end.record()
    end.synchronize()
    queue = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(iters)
        torch.cuda.synchronize()
    cupti = sum(ms for ms, _ in device_kernel_ms(torch, prof).values())
    return {"median": median, "cupti": cupti / iters, "queue": queue}


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, name, got, want, dtype, rows=None, tol=None):
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    if rows is not None:
        got, want = got[rows], want[rows]
    err = float((got - want).abs().max())
    rms = float(want.square().mean().sqrt())
    tol = TOL[dtype] if tol is None else tol
    ok = torch.allclose(got, want, **tol)
    log(f"  {name}: max_abs_err={err:.3e}, reference rms {rms:.3e} "
        f"(atol={tol['atol']}, rtol={tol['rtol']}) "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------- kernels --

def rms_phase(torch, dev, g):
    from paddle_tpu_torch.kernels import norm
    F = torch.nn.functional
    main = None
    for dtype, n in (("bfloat16", 2048), ("float32", 2048),
                     ("bfloat16", 4)):
        dt = getattr(torch, dtype)
        x = torch.randn(n, 4096, device=dev, generator=g).to(dt)
        w = (1 + 0.1 * torch.randn(4096, device=dev, generator=g)).to(dt)
        err = compare(torch, f"rms_norm {dtype} x[{n}, 4096]",
                      norm.rms_norm_kernel(x, w, 1e-6),
                      norm.rms_norm_plain(x, w, 1e-6), dtype)
        if main is None:
            sets = [(x, w)] + [(torch.randn_like(x), w) for _ in range(3)]
            t = time_ms(
                torch, lambda a, b: norm.rms_norm_kernel(a, b, 1e-6), sets)
            plain = time_ms(torch, lambda a, b: norm.rms_norm_plain(
                a, b, 1e-6), sets)["median"]
            lib = time_ms(torch, lambda a, b: F.rms_norm(
                a, (4096,), b, 1e-6), sets)["median"]
            isz = x.element_size()
            b_ms, by = bound(2 * x.numel() * isz + w.numel() * isz,
                             4 * x.numel(), "float32")
            main = dict(max_abs_err=err, t=t, plain_ms=plain,
                        library_ms=lib, bound_ms=b_ms, bound_by=by,
                        shape=f"x[{n}, 4096] {dtype}")
    return main


def prefill_mask(torch, dev, lens, s):
    j = torch.arange(s, device=dev)
    key_valid = j[None, :] >= (s - lens)[:, None]
    ok = key_valid[:, None, :] & (j[None, :] <= j[:, None])[None]
    return torch.where(ok, 0.0, NEG).float()[:, None], key_valid


def flash_phase(torch, dev, g):
    from paddle_tpu_torch.kernels import attention as A
    F = torch.nn.functional
    b, s, d = 4, 512, 128
    lens = torch.tensor([512, 384, 200, 64], device=dev)
    mask, key_valid = prefill_mask(torch, dev, lens, s)
    main = None
    for dtype, h, hkv in (("bfloat16", 32, 32), ("float32", 32, 32),
                          ("bfloat16", 32, 8)):
        dt = getattr(torch, dtype)
        q = torch.randn(b, s, h, d, device=dev, generator=g).to(dt)
        k = torch.randn(b, s, hkv, d, device=dev, generator=g).to(dt)
        v = torch.randn(b, s, hkv, d, device=dev, generator=g).to(dt)
        sc = d ** -0.5
        out, lse = A.flash_attention_kernel(q, k, v, sc, True, mask)
        want = A.flash_attention_plain(q, k, v, sc, True, mask)
        check(bool(torch.isfinite(lse).all()), "flash lse non-finite")
        err = compare(torch, f"flash_fwd causal+mask {dtype} "
                      f"q[{b}, {s}, {h}, {d}] Hkv={hkv}", out, want, dtype,
                      rows=key_valid)
        if main is None:
            sets = [(q, k, v), tuple(torch.randn_like(t) for t in (q, k, v))]
            t = time_ms(torch, lambda a, b, c: A.flash_attention_kernel(
                a, b, c, sc, True, mask), sets)
            plain = time_ms(torch, lambda a, b, c: A.flash_attention_plain(
                a, b, c, sc, True, mask), sets)["median"]
            # one PyTorch call of the same function: SDPA with the same
            # float mask (the causal part folded in, as SDPA takes one)
            causal = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                           device=dev))
            full = (mask + torch.where(causal, 0.0, NEG)).to(dt)
            lib = time_ms(
                torch, lambda a, b, c: F.scaled_dot_product_attention(
                    a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
                    attn_mask=full, scale=sc), sets)["median"]
            # work the data needs: (query, key) pairs left by causal +
            # padding, per head; bytes: q, k, v, mask, out, lse once
            pairs = int(((mask[:, 0] > NEG / 2) & causal).sum()) * h
            isz = q.element_size()
            nbytes = (3 * q.numel() * isz + mask.numel() * 4
                      + q.numel() * isz + lse.numel() * 4)
            b_ms, by = bound(nbytes, 4 * d * pairs, dtype)
            main = dict(max_abs_err=err, t=t, plain_ms=plain,
                        library_ms=lib, bound_ms=b_ms, bound_by=by,
                        shape=f"q[{b}, {s}, {h}, {d}] {dtype} causal+mask")
        elif dtype == "float32" and hkv == h:
            # the f32 instance (FMA units) at the same shape, logged
            sets = [(q, k, v), tuple(torch.randn_like(t) for t in (q, k, v))]
            t32 = time_ms(torch, lambda a, b, c: A.flash_attention_kernel(
                a, b, c, sc, True, mask), sets)["median"]
            log(f"  flash_fwd float32 q[{b}, {s}, {h}, {d}] causal+mask: "
                f"{t32:.4f} ms (median device time)")
    main["extra"] = {**flash_train_row(torch, dev, g),
                     **flash_decode_row(torch, dev, g)}
    # suffix prefill: Sq < Sk, causality carried by the mask alone
    sq, sk = 128, 384
    q = torch.randn(1, sq, 32, d, device=dev, generator=g).bfloat16()
    k = torch.randn(1, sk, 32, d, device=dev, generator=g).bfloat16()
    v = torch.randn(1, sk, 32, d, device=dev, generator=g).bfloat16()
    jq = torch.arange(sq, device=dev)[:, None]
    jk = torch.arange(sk, device=dev)[None, :]
    m = torch.where((jk < 200) | ((jk >= sk - sq) & (jk - (sk - sq) <= jq)),
                    0.0, NEG).float()[None, None]
    compare(torch, "flash_fwd suffix mask-only bfloat16 q[1, 128, 32, 128] "
            "Sk=384", A.flash_attention_kernel(q, k, v, d ** -0.5, False,
                                               m)[0],
            A.flash_attention_plain(q, k, v, d ** -0.5, False, m),
            "bfloat16")
    return main


def flash_train_row(torch, dev, g):
    """The forward at the training shape, q[2, 2048, 32, 128] bf16 causal
    without a mask, with lse (what each layer of the training run
    launches): against its plain version, timed beside causal SDPA at the
    same shape and the operations bound of the causal pairs."""
    from paddle_tpu_torch.kernels import attention as A
    F = torch.nn.functional
    b, s, h, d = 2, 2048, 32, 128
    sets = [tuple(torch.randn(b, s, h, d, device=dev, generator=g).bfloat16()
                  for _ in range(3)) for _ in range(2)]
    sc = d ** -0.5
    out, lse = A.flash_attention_kernel(*sets[0], sc, True)
    want, want_lse = A.flash_attention_plain(*sets[0], sc, True,
                                             return_lse=True)
    shape = f"q[{b}, {s}, {h}, {d}] bfloat16 causal"
    err = compare(torch, f"flash_fwd {shape}", out, want, "bfloat16")
    compare(torch, f"flash_fwd lse {shape}", lse, want_lse, "float32")
    t = time_ms(torch, lambda a, c, e: A.flash_attention_kernel(
        a, c, e, sc, True), sets)
    lib = time_ms(torch, lambda a, c, e: F.scaled_dot_product_attention(
        a.transpose(1, 2), c.transpose(1, 2), e.transpose(1, 2),
        is_causal=True, scale=sc), sets)["median"]
    pairs = b * h * s * (s + 1) // 2
    nbytes = 4 * out.numel() * out.element_size() + lse.numel() * 4
    b_ms, by = bound(nbytes, 4 * d * pairs, "bfloat16")
    log(f"  flash_fwd at the training shape, {shape}: kernel median "
        f"{t['median']:.4f} ms (CUPTI {t['cupti']:.4f}), bound {b_ms:.4f} "
        f"ms ({by}), SDPA {lib:.4f} ms")
    return {"train_shape": shape, "train_ms": t["median"],
            "train_bound_ms": b_ms, "train_library_ms": lib,
            "train_max_abs_err": err}


def flash_bwd_phase(torch, dev, g):
    """Both backward kernels against the plain backward on the same
    inputs (q, k, v, dO random; out and lse from the forward kernel),
    each bf16 case's largest error logged beside the output's largest
    value; two bf16 launches must agree bit for bit; timed at the training
    shape, q[2, 2048, 32, 128] bf16 causal, and at head_dim 64 (logged)."""
    from paddle_tpu_torch.kernels import attention as A
    F = torch.nn.functional
    # (dtype, B, Sq, Sk, H, Hkv, D, causal, key-padding mask + kv_lens)
    cases = [("bfloat16", 2, 2048, 2048, 32, 32, 128, True, False),
             ("float32", 2, 2048, 2048, 32, 32, 128, True, False),
             ("bfloat16", 2, 2048, 2048, 32, 8, 128, True, False),
             ("bfloat16", 2, 1024, 1024, 16, 16, 64, True, False),
             ("bfloat16", 2, 384, 640, 32, 32, 128, False, True),
             ("bfloat16", 2, 2048, 2048, 32, 32, 64, True, False)]

    def inputs(dt, b, sq, sk, h, hkv, d, causal, mask, lens):
        q = torch.randn(b, sq, h, d, device=dev, generator=g).to(dt)
        k = torch.randn(b, sk, hkv, d, device=dev, generator=g).to(dt)
        v = torch.randn(b, sk, hkv, d, device=dev, generator=g).to(dt)
        do = torch.randn(b, sq, h, d, device=dev, generator=g).to(dt)
        out, lse = A.flash_attention_kernel(q, k, v, d ** -0.5, causal, mask,
                                            lens)
        return q, k, v, do, lse, A.bwd_delta(out, do), out

    rows = {}
    for dtype, b, sq, sk, h, hkv, d, causal, padded in cases:
        dt = getattr(torch, dtype)
        mask = lens = None
        if padded:
            mask = torch.zeros(b, 1, 1, sk, device=dev)
            mask[1, ..., -100:] = NEG
            lens = torch.tensor([sk, sk - 128], dtype=torch.int32,
                                device=dev)
        sc = d ** -0.5
        q, k, v, do, lse, delta, out = inputs(dt, b, sq, sk, h, hkv, d,
                                              causal, mask, lens)
        dk, dv = A.flash_bwd_dkdv_kernel(q, k, v, do, lse, delta, sc, causal,
                                         mask, lens)
        dq = A.flash_bwd_dq_kernel(q, k, v, do, lse, delta, sc, causal,
                                   mask, lens)
        want = A.flash_attention_bwd_plain(q, k, v, out, lse, do, sc, causal,
                                           mask, lens)
        name = (f"{dtype} q[{b}, {sq}, {h}, {d}] Sk={sk} Hkv={hkv} "
                f"{'causal' if causal else 'non-causal'}"
                f"{' + key mask + kv_lens' if padded else ''}")
        errs = [compare(torch, f"flash_bwd_{w} {name}", got, ref, dtype)
                for w, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       want)]
        if dtype == "bfloat16":
            # the tensor-core kernels take P and dS as bf16 hi + lo parts
            # where the plain version keeps them in f32
            tops = [float(w.float().abs().max()) for w in want]
            log("  bf16 error over the largest |value|: " + ", ".join(
                f"{w} {e:.3e} / {t:.3e} = {e / t:.3e}"
                for w, e, t in zip(("dq", "dk", "dv"), errs, tops)))
            again = (A.flash_bwd_dq_kernel(q, k, v, do, lse, delta, sc,
                                           causal, mask, lens),
                     *A.flash_bwd_dkdv_kernel(q, k, v, do, lse, delta, sc,
                                              causal, mask, lens))
            check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv),
                                                        again)),
                  f"flash_bwd {name}: a second launch differs")
        if d == 64 and sq == 2048:
            sets = [(q, k, v, do, lse, delta),
                    inputs(dt, b, sq, sk, h, hkv, d, causal, None, None)[:6]]
            t64 = [time_ms(torch, fn, sets)["median"] for fn in (
                lambda q_, k_, v_, do_, l_, dl_: A.flash_bwd_dkdv_kernel(
                    q_, k_, v_, do_, l_, dl_, sc, True),
                lambda q_, k_, v_, do_, l_, dl_: A.flash_bwd_dq_kernel(
                    q_, k_, v_, do_, l_, dl_, sc, True))]
            log(f"  flash_bwd at {name}: dkdv {t64[0]:.4f} ms, dq "
                f"{t64[1]:.4f} ms (median device time)")
        if rows:
            continue
        # the timed case: two input sets (~200 MB each, past the L2)
        sets = [(q, k, v, do, lse, delta, out),
                inputs(dt, b, sq, sk, h, hkv, d, causal, None, None)]
        t_kv = time_ms(torch, lambda q_, k_, v_, do_, l_, dl_, o_:
                       A.flash_bwd_dkdv_kernel(q_, k_, v_, do_, l_, dl_, sc,
                                               True), sets)
        t_q = time_ms(torch, lambda q_, k_, v_, do_, l_, dl_, o_:
                      A.flash_bwd_dq_kernel(q_, k_, v_, do_, l_, dl_, sc,
                                            True), sets)
        plain = time_ms(torch, lambda q_, k_, v_, do_, l_, dl_, o_:
                        A.flash_attention_bwd_plain(q_, k_, v_, o_, l_, do_,
                                                    sc, True),
                        sets)["median"]
        # one PyTorch call of the same function: the backward of causal
        # SDPA, dQ, dK and dV together
        graphs = []
        for q_, k_, v_, do_, *_ in sets:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q_, k_, v_))
            graphs.append((F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), (qt, kt, vt),
                do_.transpose(1, 2)))
        lib = time_ms(torch, lambda o_, ins, g_: torch.autograd.grad(
            o_, ins, g_, retain_graph=True), graphs)["median"]
        del graphs
        # work of this run's inputs: causal (query, key) pairs per head;
        # dK/dV does 4 products (Q K^T, P^T dO, dO V^T, dS^T Q), dQ 3;
        # bytes: each input read once, each output written once
        pairs = b * h * sq * (sq + 1) // 2
        isz = q.element_size()
        rows_b = 2 * lse.numel() * 4
        qb_, kb_ = q.numel() * isz, k.numel() * isz
        kv_b, kvq_b = bound(2 * qb_ + 4 * kb_ + rows_b, 8 * d * pairs,
                            dtype)
        q_b, qq_b = bound(3 * qb_ + 2 * kb_ + rows_b, 6 * d * pairs, dtype)
        shape = f"q[{b}, {sq}, {h}, {d}] {dtype} causal"
        common = dict(plain_ms=plain, library_ms=lib, shape=shape)
        rows["flash_bwd_dkdv"] = dict(max_abs_err=max(errs[1:]), t=t_kv,
                                      bound_ms=kv_b, bound_by=kvq_b, **common)
        rows["flash_bwd_dq"] = dict(max_abs_err=errs[0], t=t_q, bound_ms=q_b,
                                    bound_by=qq_b, **common)
    return rows


def paged_phase(torch, dev, g):
    from paddle_tpu_torch.kernels import paged_attention as P
    b, d, page, pps = 4, 128, 16, 64
    num_pages = b * pps + 1
    lens = torch.tensor([557, 300, 97, 1], dtype=torch.int32, device=dev)
    tables = torch.randperm(num_pages, device=dev, generator=g)[
        :b * pps].reshape(b, pps).to(torch.int32).contiguous()
    main = None
    for dtype, h, hkv in (("bfloat16", 32, 32), ("float32", 32, 32),
                          ("bfloat16", 32, 8)):
        dt = getattr(torch, dtype)
        q = torch.randn(b, h, d, device=dev, generator=g).to(dt)
        kp = torch.randn(num_pages, page, hkv, d, device=dev,
                         generator=g).to(dt)
        vp = torch.randn(num_pages, page, hkv, d, device=dev,
                         generator=g).to(dt)
        sc = d ** -0.5
        err = compare(
            torch, f"paged_decode {dtype} q[{b}, {h}, {d}] Hkv={hkv} "
            f"ctx={lens.tolist()}",
            P.paged_attention_kernel(q, kp, vp, tables, lens, sc),
            P.paged_attention_plain(q, kp, vp, tables, lens, sc), dtype)
        if main is None:
            sets = [(kp, vp)] + [(torch.randn_like(kp), torch.randn_like(vp))
                                 for _ in range(3)]
            t = time_ms(torch, lambda a, b: P.paged_attention_kernel(
                q, a, b, tables, lens, sc), sets)
            plain = time_ms(torch, lambda a, b: P.paged_attention_plain(
                q, a, b, tables, lens, sc), sets)["median"]
            toks = int(lens.sum())
            isz = q.element_size()
            nbytes = (2 * q.numel() * isz + 2 * toks * hkv * d * isz
                      + tables.numel() * 4 + lens.numel() * 4)
            b_ms, by = bound(nbytes, 4 * d * h * toks, dtype)
            main = dict(max_abs_err=err, t=t, plain_ms=plain,
                        library_ms=None, bound_ms=b_ms, bound_by=by,
                        shape=f"q[{b}, {h}, {d}] {dtype} page={page} "
                              f"ctx={lens.tolist()}")
            main["extra"] = paged_long_row(torch, dev, q, sets, tables,
                                           page, sc, lens)
        elif dtype == "float32":
            # the f32 instance (one block per walk) at the same shape
            sets = [(kp, vp)] + [(torch.randn_like(kp), torch.randn_like(vp))
                                 for _ in range(3)]
            t32 = time_ms(torch, lambda a, b: P.paged_attention_kernel(
                q, a, b, tables, lens, sc), sets)["median"]
            log(f"  paged_decode float32 q[{b}, {h}, {d}] ctx="
                f"{lens.tolist()}: {t32:.4f} ms (median device time)")
    # context_lens past pps * page attend to the keys the table names
    # (the last case's bf16 GQA pages)
    q = torch.randn(2, 32, d, device=dev, generator=g).bfloat16()
    over = torch.tensor([pps * page + 9, 2 * pps * page], dtype=torch.int32,
                        device=dev)
    compare(torch, f"paged_decode bfloat16 Hkv=8 ctx={over.tolist()} > "
            f"pps*page={pps * page}",
            P.paged_attention_kernel(q, kp, vp, tables[:2].contiguous(), over,
                                     d ** -0.5),
            P.paged_attention_plain(q, kp, vp, tables[:2].contiguous(), over,
                                    d ** -0.5), "bfloat16")
    # context_lens == 0 rows are zero
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    out = P.paged_attention_kernel(q, kp, vp, tables[:2].contiguous(), zero,
                                   0.1)
    check(not bool(out.any()), "paged_decode: context_lens == 0 rows not 0")
    return main


def paged_long_row(torch, dev, q, sets, tables, page, sc, serve_lens):
    """bf16 decode at a long context, up to pps * page = 1024 tokens (the
    first sequence's walk spans every rank of the cluster), against the
    plain version, timed beside ragged_decode on the same inputs and the
    bytes bound (ragged_decode held to its plain version there too);
    and ragged_decode on the serving shape's inputs."""
    from paddle_tpu_torch.kernels import paged_attention as P
    meta = _builder_meta(torch, dev, tables, serve_lens, page)
    serve_rag = time_ms(torch, lambda a, b: P.paged_attention_ragged_kernel(
        q, a, b, serve_lens, meta, sc), sets)["median"]
    log(f"  ragged_decode on paged_decode's inputs, ctx="
        f"{serve_lens.tolist()}: {serve_rag:.4f} ms")
    lens = torch.tensor([tables.shape[1] * page, 1000, 700, 333],
                        dtype=torch.int32, device=dev)
    kp, vp = sets[0]
    err = compare(torch, f"paged_decode bfloat16 q{list(q.shape)} ctx="
                  f"{lens.tolist()}",
                  P.paged_attention_kernel(q, kp, vp, tables, lens, sc),
                  P.paged_attention_plain(q, kp, vp, tables, lens, sc),
                  "bfloat16")
    t = time_ms(torch, lambda a, b: P.paged_attention_kernel(
        q, a, b, tables, lens, sc), sets)["median"]
    meta = _builder_meta(torch, dev, tables, lens, page)
    rag_err = compare(torch, f"ragged_decode bfloat16 q{list(q.shape)} ctx="
                      f"{lens.tolist()} G={meta.shape[1]}",
                      P.paged_attention_ragged_kernel(q, kp, vp, lens, meta,
                                                      sc),
                      P.paged_attention_ragged_plain(q, kp, vp, lens, meta,
                                                     sc), "bfloat16")
    rag = time_ms(torch, lambda a, b: P.paged_attention_ragged_kernel(
        q, a, b, lens, meta, sc), sets)["median"]
    isz, hkv, d = q.element_size(), kp.shape[2], q.shape[2]
    toks = int(lens.sum())
    b_ms, by = bound(2 * q.numel() * isz + 2 * toks * hkv * d * isz
                     + tables.numel() * 4 + lens.numel() * 4,
                     4 * d * q.shape[1] * toks, "bfloat16")
    log(f"  paged_decode at long contexts {lens.tolist()}: kernel median "
        f"{t:.4f} ms, bound {b_ms:.4f} ms ({by}), ragged_decode on the "
        f"same inputs {rag:.4f} ms")
    return {"ragged_ms": serve_rag, "long_ctx": lens.tolist(),
            "long_ms": t, "long_bound_ms": b_ms, "long_ragged_ms": rag,
            "long_max_abs_err": err, "long_ragged_max_abs_err": rag_err}


def _builder_meta(torch, dev, tables, lens, page):
    """The serving loop's ragged meta for these tables / post-write
    lengths, as an int32 [6, G] tensor on the card."""
    from paddle_tpu_torch.kernels.paged_attention import RaggedMetaBuilder
    b, pps = tables.shape
    builder = RaggedMetaBuilder(b, pps, page, trash_page=0)
    tab = tables.cpu().numpy()
    for s, n in enumerate(lens.tolist()):
        builder.set_slot(s, tab[s], n)
    return torch.from_numpy(builder.stacked()).to(dev)


def ragged_phase(torch, dev, g):
    from paddle_tpu_torch.kernels import paged_attention as P
    b, d, page, pps = 4, 128, 16, 64
    num_pages = b * pps + 1
    lens = torch.tensor([557, 300, 97, 1], dtype=torch.int32, device=dev)
    tables = torch.randperm(num_pages, device=dev, generator=g)[
        :b * pps].reshape(b, pps).to(torch.int32).contiguous()
    meta = _builder_meta(torch, dev, tables, lens, page)
    main = None
    for dtype, h, hkv in (("bfloat16", 32, 32), ("float32", 32, 32),
                          ("bfloat16", 32, 8)):
        dt = getattr(torch, dtype)
        q = torch.randn(b, h, d, device=dev, generator=g).to(dt)
        kp = torch.randn(num_pages, page, hkv, d, device=dev,
                         generator=g).to(dt)
        vp = torch.randn(num_pages, page, hkv, d, device=dev,
                         generator=g).to(dt)
        sc = d ** -0.5
        out = P.paged_attention_ragged_kernel(q, kp, vp, lens, meta, sc)
        err = compare(
            torch, f"ragged_decode {dtype} q[{b}, {h}, {d}] Hkv={hkv} "
            f"ctx={lens.tolist()} G={meta.shape[1]}", out,
            P.paged_attention_ragged_plain(q, kp, vp, lens, meta, sc), dtype)
        check(torch.equal(out, P.paged_attention_ragged_kernel(
            q, kp, vp, lens, meta, sc)),
            f"ragged_decode {dtype}: a second launch differs from the first")
        if dtype == "float32":
            # the same function as the block-table kernel
            compare(torch, "ragged_decode vs paged_decode float32", out,
                    P.paged_attention_kernel(q, kp, vp, tables, lens, sc),
                    dtype)
        if main is None:
            sets = [(kp, vp)] + [(torch.randn_like(kp), torch.randn_like(vp))
                                 for _ in range(3)]
            t = time_ms(torch, lambda a, c: P.paged_attention_ragged_kernel(
                q, a, c, lens, meta, sc), sets)
            plain = time_ms(torch, lambda a, c: P.paged_attention_ragged_plain(
                q, a, c, lens, meta, sc), sets)["median"]
            toks = int(lens.sum())
            isz = q.element_size()
            nbytes = (2 * q.numel() * isz + 2 * toks * hkv * d * isz
                      + meta.numel() * 4 + lens.numel() * 4)
            b_ms, by = bound(nbytes, 4 * d * h * toks, dtype)
            # the block-table kernel on the same inputs
            paged = time_ms(torch, lambda a, c: P.paged_attention_kernel(
                q, a, c, tables, lens, sc), sets)["median"]
            main = dict(max_abs_err=err, t=t, plain_ms=plain,
                        library_ms=None, bound_ms=b_ms, bound_by=by,
                        shape=f"q[{b}, {h}, {d}] {dtype} page={page} "
                              f"ctx={lens.tolist()} G={meta.shape[1]}",
                        extra={"paged_ms": paged})
    # context_lens == 0 rows are zero
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    out = P.paged_attention_ragged_kernel(q, kp, vp, zero, meta, 0.1)
    check(not bool(out.any()), "ragged_decode: context_lens == 0 rows not 0")
    return main


def varq_phase(torch, dev, g):
    from paddle_tpu_torch.kernels import paged_attention as P
    b, qb, d, page, pps = 4, 256, 128, 16, 64
    num_pages = b * pps + 1
    q_lens = torch.tensor([256, 1, 1, 97], dtype=torch.int32, device=dev)
    kv_lens = torch.tensor([512, 301, 98, 97], dtype=torch.int32, device=dev)
    tables = torch.randperm(num_pages, device=dev, generator=g)[
        :b * pps].reshape(b, pps).to(torch.int32).contiguous()
    meta = _builder_meta(torch, dev, tables, kv_lens, page)
    rows = torch.arange(qb, device=dev)[None, :] < q_lens[:, None]
    main = None
    for dtype, h, hkv in (("bfloat16", 32, 32), ("float32", 32, 32),
                          ("bfloat16", 32, 8)):
        dt = getattr(torch, dtype)
        q = torch.randn(b, qb, h, d, device=dev, generator=g).to(dt)
        kp = torch.randn(num_pages, page, hkv, d, device=dev,
                         generator=g).to(dt)
        vp = torch.randn(num_pages, page, hkv, d, device=dev,
                         generator=g).to(dt)
        sc = d ** -0.5
        name = (f"paged_varq {dtype} q[{b}, {qb}, {h}, {d}] Hkv={hkv} "
                f"q_lens={q_lens.tolist()} kv_lens={kv_lens.tolist()}")
        out = P.paged_attention_varq_kernel(q, kp, vp, kv_lens, q_lens, sc,
                                            meta=meta)
        err = compare(torch, name + " (meta)", out,
                      P.paged_attention_ragged_varq_plain(
                          q, kp, vp, kv_lens, q_lens, meta, sc), dtype)
        compare(torch, name + " (block table)",
                P.paged_attention_varq_kernel(q, kp, vp, kv_lens, q_lens, sc,
                                              block_tables=tables),
                P.paged_attention_varq_plain(q, kp, vp, tables, kv_lens,
                                             q_lens, sc), dtype)
        check(not bool(out[~rows].any()), "paged_varq: padding rows not 0")
        check(torch.equal(out, P.paged_attention_varq_kernel(
            q, kp, vp, kv_lens, q_lens, sc, meta=meta)),
            f"paged_varq {dtype}: a second launch differs from the first")
        if main is None:
            sets = [(kp, vp)] + [(torch.randn_like(kp), torch.randn_like(vp))
                                 for _ in range(3)]
            t = time_ms(torch, lambda a, c: P.paged_attention_varq_kernel(
                q, a, c, kv_lens, q_lens, sc, meta=meta), sets)
            # the plain version of the same function through the block
            # table (the meta route's plain version reads its page count
            # back to the host)
            plain = time_ms(torch, lambda a, c: P.paged_attention_varq_plain(
                q, a, c, tables, kv_lens, q_lens, sc), sets)["median"]
            b_ms, by = varq_bound(q, q_lens, kv_lens, hkv, meta)
            main = dict(max_abs_err=err, t=t, plain_ms=plain,
                        library_ms=None, bound_ms=b_ms, bound_by=by,
                        shape=f"q[{b}, {qb}, {h}, {d}] {dtype} page={page} "
                              f"q_lens={q_lens.tolist()} "
                              f"kv_lens={kv_lens.tolist()}",
                        extra=varq_verify_row(torch, dev, g, sets, tables,
                                              page, sc))
        if dtype == "float32":
            # single-token spans are decode attention: against the
            # ragged decode kernel, f32 tolerance
            ones = torch.ones_like(q_lens)
            span = P.paged_attention_varq_kernel(
                q[:, :1].contiguous(), kp, vp, kv_lens, ones, sc, meta=meta)
            compare(torch, "paged_varq q_lens == 1 vs ragged_decode float32",
                    span[:, 0], P.paged_attention_ragged_kernel(
                        q[:, 0].contiguous(), kp, vp, kv_lens, meta, sc),
                    dtype)
    return main


def varq_bound(q, q_lens, kv_lens, hkv, meta, kv_isz=None, op_type=None):
    """The least time of a varq call: bytes (the real span rows of q read
    once, padding rows never, the whole output written once, each slot's
    keys and values, of ``kv_isz`` bytes each where the pages' dtype is
    not q's, the meta and both length vectors) or operations (the
    (query, key) pairs the causal spans need, per head, at the peak of
    ``op_type``, by default q's dtype)."""
    b, _, h, d = q.shape
    start = (kv_lens - q_lens).long()
    pairs = sum(int(s) * n + n * (n + 1) // 2 for s, n in
                zip(start.tolist(), q_lens.tolist()))
    isz = q.element_size()
    nbytes = (int(q_lens.sum()) * h * d * isz + q.numel() * isz
              + 2 * int(kv_lens.sum()) * hkv * d * (kv_isz or isz)
              + meta.numel() * 4 + 2 * b * 4)
    return bound(nbytes, 4 * d * h * pairs,
                 op_type or str(q.dtype).split(".")[-1])


def varq_verify_row(torch, dev, g, sets, tables, page, sc):
    """paged_varq at the speculative verify shape, q[4, 5, 32, 128] bf16
    (1 + 4 drafts per slot) over contexts 561 / 305 / 101 / 5: one query
    tile per slot, so each walk is split over a cluster. Held to its plain
    version through the meta and the block table, timed beside the plain
    version and the bound; returns the ``verify_*`` keys."""
    from paddle_tpu_torch.kernels import paged_attention as P
    kp, vp = sets[0]
    q = torch.randn(4, 5, kp.shape[2], kp.shape[3], device=dev,
                    generator=g).bfloat16()
    q_lens = torch.full((4,), 5, dtype=torch.int32, device=dev)
    kv_lens = torch.tensor([561, 305, 101, 5], dtype=torch.int32,
                           device=dev)
    meta = _builder_meta(torch, dev, tables, kv_lens, page)
    shape = (f"q{list(q.shape)} bfloat16 page={page} q_lens="
             f"{q_lens.tolist()} kv_lens={kv_lens.tolist()}")
    out = P.paged_attention_varq_kernel(q, kp, vp, kv_lens, q_lens, sc,
                                        meta=meta)
    err = compare(torch, f"paged_varq {shape} (meta)", out,
                  P.paged_attention_ragged_varq_plain(
                      q, kp, vp, kv_lens, q_lens, meta, sc), "bfloat16")
    compare(torch, f"paged_varq {shape} (block table)",
            P.paged_attention_varq_kernel(q, kp, vp, kv_lens, q_lens, sc,
                                          block_tables=tables),
            P.paged_attention_varq_plain(q, kp, vp, tables, kv_lens, q_lens,
                                         sc), "bfloat16")
    check(torch.equal(out, P.paged_attention_varq_kernel(
        q, kp, vp, kv_lens, q_lens, sc, meta=meta)),
        "paged_varq verify: a second launch differs from the first")
    t = time_ms(torch, lambda a, c: P.paged_attention_varq_kernel(
        q, a, c, kv_lens, q_lens, sc, meta=meta), sets)["median"]
    plain = time_ms(torch, lambda a, c: P.paged_attention_varq_plain(
        q, a, c, tables, kv_lens, q_lens, sc), sets)["median"]
    b_ms, by = varq_bound(q, q_lens, kv_lens, kp.shape[2], meta)
    log(f"  paged_varq at the verify shape {shape}: kernel median {t:.4f} "
        f"ms, bound {b_ms:.4f} ms ({by}), plain {plain:.4f} ms")
    return {"verify_shape": shape, "verify_ms": t, "verify_plain_ms": plain,
            "verify_bound_ms": b_ms, "verify_bound_by": by,
            "verify_max_abs_err": err}


def ln_phase(torch, dev, g):
    """The LayerNorm kernel against its plain version at BERT-base's
    x[2048, 768] (16 x 128 tokens) in f32 and bf16, eps 1e-12; timed in
    both dtypes, the f32 numbers go into the kernels line."""
    from paddle_tpu_torch.kernels import norm
    F = torch.nn.functional
    d, n = 768, 2048
    rows = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        x = (3 * torch.randn(n, d, device=dev, generator=g) + 1).to(dt)
        w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        b = (0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
        err = compare(torch, f"layer_norm {dtype} x[{n}, {d}]",
                      norm.layer_norm_kernel(x, w, b, 1e-12),
                      norm.layer_norm_plain(x, w, b, 1e-12), dtype)
        # 12 input sets of 6.3 MB at f32, 24 of 3.1 MB at bf16: ~75 MB
        # of x rotate past the 50 MB L2 in both dtypes
        sets = [(x, w, b)] + [(torch.randn_like(x), w, b)
                              for _ in range(48 // x.element_size() - 1)]
        t = time_ms(torch, lambda a, c, e: norm.layer_norm_kernel(
            a, c, e, 1e-12), sets)
        plain = time_ms(torch, lambda a, c, e: norm.layer_norm_plain(
            a, c, e, 1e-12), sets)["median"]
        lib = time_ms(torch, lambda a, c, e: F.layer_norm(
            a, (d,), c, e, 1e-12), sets)["median"]
        isz = x.element_size()
        # bytes: x read once, y written once, w and b once; ~8 operations
        # per element (sum, centre, square, sum, scale, weight, bias)
        b_ms, by = bound(2 * x.numel() * isz + 2 * d * isz, 8 * x.numel(),
                         "float32")
        rows[dtype] = dict(max_abs_err=err, t=t, plain_ms=plain,
                           library_ms=lib, bound_ms=b_ms, bound_by=by,
                           shape=f"x[{n}, {d}] {dtype}")
    return rows


# ------------------------------------------ f16 and mixed-dtype instances --

# (q dtype, K/V or page dtype) of the mixed rows: a bf16 model's queries
# over an f32 KV pool (serve run KV) and an f32 model's over a bf16 pool
# (the 2-layer card-vs-CPU gate)
MIXED_PAIRS = (("bfloat16", "float32"), ("float32", "bfloat16"))
_NARROW = {"float32": 0, "float16": 1, "bfloat16": 2}


def pair_tol(qd, kd):
    """A kernel's tolerance on q and K/V of dtypes ``qd``, ``kd``: the
    narrower dtype's ``TOL`` (the output is rounded to q's dtype, P to
    V's before P.V)."""
    return TOL[max(qd, kd, key=_NARROW.__getitem__)]


def ops_type(qd, kd):
    """The type whose peak bounds a row's operations: f32 where either
    operand is f32 (the FMA instances), else the 16-bit type."""
    return "float32" if "float32" in (qd, kd) else qd


def row_name(kernel, qd, kd=None):
    """A kernels-line row's name: "paged_decode (float16)" for one dtype,
    "paged_decode (bfloat16 q, float32 kv)" for two."""
    if kd in (None, qd):
        return f"{kernel} ({qd})"
    return f"{kernel} ({qd} q, {kd} kv)"


def dtype_row(torch, name, fn, plain, sets, tol, nbytes, ops, op_type,
              shape, lib=None, rows=None):
    """One f16 / mixed row: ``fn`` (the kernel wrapper) against ``plain``
    on ``sets[0]`` within ``tol``, a second launch bitwise the first,
    then the median time of ``fn``, ``plain`` and (where one PyTorch call
    computes the same function) ``lib`` over ``sets``, beside the bound."""
    out = fn(*sets[0])
    err = compare(torch, name, out, plain(*sets[0]), None, rows=rows,
                  tol=tol)
    check(torch.equal(out, fn(*sets[0])),
          f"{name}: a second launch differs from the first")
    t = time_ms(torch, fn, sets)
    b_ms, by = bound(nbytes, ops, op_type)
    return dict(max_abs_err=err, t=t,
                plain_ms=time_ms(torch, plain, sets)["median"],
                library_ms=None if lib is None
                else time_ms(torch, lib, sets)["median"],
                bound_ms=b_ms, bound_by=by, shape=shape)


def dtype_phase(torch, dev, g):
    """The f16 and mixed-dtype instances of every serving kernel at the
    bf16 rows' shapes, each held to its plain version (``pair_tol``) with
    a bitwise second launch, timed beside its bound, its plain version
    and the one-call PyTorch equivalent where one exists (there is none
    for q and K/V of two dtypes: SDPA takes one). Returns {(kernel, q
    dtype, K/V dtype): row}."""
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.kernels import norm
    from paddle_tpu_torch.kernels import paged_attention as P
    F = torch.nn.functional
    rows = {}
    f16 = torch.float16

    # RMSNorm at x[2048, 4096] and LayerNorm at BERT-base's x[2048, 768]
    x = torch.randn(2048, 4096, device=dev, generator=g).to(f16)
    w = (1 + 0.1 * torch.randn(4096, device=dev, generator=g)).to(f16)
    sets = [(x, w)] + [(torch.randn_like(x), w) for _ in range(3)]
    rows["rms_norm", "float16", "float16"] = dtype_row(
        torch, "rms_norm float16 x[2048, 4096]",
        lambda a, b: norm.rms_norm_kernel(a, b, 1e-6),
        lambda a, b: norm.rms_norm_plain(a, b, 1e-6), sets, TOL["float16"],
        2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel(), "float32",
        "x[2048, 4096] float16",
        lib=lambda a, b: F.rms_norm(a, (4096,), b, 1e-6))
    x = (3 * torch.randn(2048, 768, device=dev, generator=g) + 1).to(f16)
    w = (1 + 0.1 * torch.randn(768, device=dev, generator=g)).to(f16)
    b_ = (0.1 * torch.randn(768, device=dev, generator=g)).to(f16)
    sets = [(x, w, b_)] + [(torch.randn_like(x), w, b_) for _ in range(23)]
    rows["layer_norm", "float16", "float16"] = dtype_row(
        torch, "layer_norm float16 x[2048, 768]",
        lambda a, c, e: norm.layer_norm_kernel(a, c, e, 1e-12),
        lambda a, c, e: norm.layer_norm_plain(a, c, e, 1e-12), sets,
        TOL["float16"], 2 * x.numel() * 2 + 2 * 768 * 2, 8 * x.numel(),
        "float32", "x[2048, 768] float16",
        lib=lambda a, c, e: F.layer_norm(a, (768,), c, e, 1e-12))

    # flash forward: f16 at the prefill shape (and the static decode
    # shape), q bf16 over f32 K/V at a suffix-prefill shape
    b, s, h, d = 4, 512, 32, 128
    sc = d ** -0.5
    lens = torch.tensor([512, 384, 200, 64], device=dev)
    mask, key_valid = prefill_mask(torch, dev, lens, s)
    causal = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))
    full = (mask + torch.where(causal, 0.0, NEG)).to(f16)
    sets = [tuple(torch.randn(b, s, h, d, device=dev, generator=g).to(f16)
                  for _ in range(3)) for _ in range(2)]
    pairs = int(((mask[:, 0] > NEG / 2) & causal).sum()) * h
    n = sets[0][0].numel()
    row = dtype_row(
        torch, f"flash_fwd causal+mask float16 q[{b}, {s}, {h}, {d}]",
        lambda q, k, v: A.flash_attention_kernel(q, k, v, sc, True, mask)[0],
        lambda q, k, v: A.flash_attention_plain(q, k, v, sc, True, mask),
        sets, TOL["float16"],
        4 * n * 2 + mask.numel() * 4 + b * h * s * 4, 4 * d * pairs,
        "float16", f"q[{b}, {s}, {h}, {d}] float16 causal+mask",
        lib=lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=full, scale=sc), rows=key_valid)
    row["extra"] = flash_decode_row(torch, dev, g, "float16")
    rows["flash_fwd", "float16", "float16"] = row
    sq, sk = 128, 384
    jq = torch.arange(sq, device=dev)[:, None]
    jk = torch.arange(sk, device=dev)[None, :]
    m = torch.where((jk < 200) | ((jk >= sk - sq) & (jk - (sk - sq) <= jq)),
                    0.0, NEG).float()[None, None]
    qd, kd = MIXED_PAIRS[0]
    sets = [(torch.randn(1, sq, h, d, device=dev, generator=g).to(
        getattr(torch, qd)),) + tuple(
        torch.randn(1, sk, h, d, device=dev, generator=g).to(
            getattr(torch, kd)) for _ in range(2)) for _ in range(2)]
    kept = int((m > NEG / 2).sum()) * h
    rows["flash_fwd", qd, kd] = dtype_row(
        torch, f"flash_fwd suffix mask-only q[1, {sq}, {h}, {d}] {qd}, k, v "
        f"[1, {sk}, {h}, {d}] {kd}",
        lambda q, k, v: A.flash_attention_kernel(q, k, v, sc, False, m)[0],
        lambda q, k, v: A.flash_attention_plain(q, k, v, sc, False, m),
        sets, pair_tol(qd, kd),
        2 * sq * h * d * 2 + 2 * sk * h * d * 4 + m.numel() * 4
        + h * sq * 4, 4 * d * kept, ops_type(qd, kd),
        f"q[1, {sq}, {h}, {d}] {qd}, k, v[1, {sk}, {h}, {d}] {kd}, "
        "suffix mask")

    # the decode kernels at q[4, 32, 128], contexts 557 / 300 / 97 / 1
    b, page, pps = 4, 16, 64
    num_pages = b * pps + 1
    lens = torch.tensor([557, 300, 97, 1], dtype=torch.int32, device=dev)
    tables = torch.randperm(num_pages, device=dev, generator=g)[
        :b * pps].reshape(b, pps).to(torch.int32).contiguous()
    meta = _builder_meta(torch, dev, tables, lens, page)
    toks = int(lens.sum())
    for qd, kd in (("float16", "float16"),) + MIXED_PAIRS:
        qt, kt = getattr(torch, qd), getattr(torch, kd)
        q = torch.randn(b, h, d, device=dev, generator=g).to(qt)
        sets = [tuple(torch.randn(num_pages, page, h, d, device=dev,
                                  generator=g).to(kt) for _ in range(2))
                for _ in range(4)]
        nbytes = (2 * q.numel() * q.element_size()
                  + 2 * toks * h * d * sets[0][0].element_size()
                  + lens.numel() * 4)
        shape = (f"q[{b}, {h}, {d}] {qd}, pages {kd} page={page} "
                 f"ctx={lens.tolist()}")
        rows["paged_decode", qd, kd] = dtype_row(
            torch, f"paged_decode {shape}",
            lambda a, c: P.paged_attention_kernel(q, a, c, tables, lens, sc),
            lambda a, c: P.paged_attention_plain(q, a, c, tables, lens, sc),
            sets, pair_tol(qd, kd), nbytes + tables.numel() * 4,
            4 * d * h * toks, ops_type(qd, kd), shape)
        rows["ragged_decode", qd, kd] = dtype_row(
            torch, f"ragged_decode {shape} G={meta.shape[1]}",
            lambda a, c: P.paged_attention_ragged_kernel(q, a, c, lens, meta,
                                                         sc),
            lambda a, c: P.paged_attention_ragged_plain(q, a, c, lens, meta,
                                                        sc),
            sets, pair_tol(qd, kd), nbytes + meta.numel() * 4,
            4 * d * h * toks, ops_type(qd, kd), shape + f" G={meta.shape[1]}")
        # the span kernel at its two shapes over the same pages
        rows["paged_varq", qd, kd] = varq_dtype_row(
            torch, dev, g, sets, tables, page, qt, pair_tol(qd, kd),
            ops_type(qd, kd))
    return rows


def varq_dtype_row(torch, dev, g, sets, tables, page, qt, tol, op_type):
    """paged_varq over ``sets``' pages with q of ``qt``: the mixed shape
    q[4, 256, 32, 128] (q_lens 256 / 1 / 1 / 97) as the row and the verify
    shape q[4, 5, 32, 128] (5-row spans) as its ``verify_*`` keys, each
    through the meta against its plain version, a bitwise second launch."""
    from paddle_tpu_torch.kernels import paged_attention as P
    h, d = sets[0][0].shape[2:]
    sc = d ** -0.5
    out = {}
    for key, qb, ql, kl in (("", 256, [256, 1, 1, 97], [512, 301, 98, 97]),
                            ("verify_", 5, [5] * 4, [561, 305, 101, 5])):
        q = torch.randn(4, qb, h, d, device=dev, generator=g).to(qt)
        q_lens, kv_lens = (torch.tensor(x, dtype=torch.int32, device=dev)
                           for x in (ql, kl))
        meta = _builder_meta(torch, dev, tables, kv_lens, page)
        kd = str(sets[0][0].dtype).split(".")[-1]
        shape = (f"q{list(q.shape)} {str(qt).split('.')[-1]}, pages {kd} "
                 f"page={page} q_lens={ql} kv_lens={kl}")
        b_ms, by = varq_bound(q, q_lens, kv_lens, h, meta,
                              kv_isz=sets[0][0].element_size(),
                              op_type=op_type)
        row = dtype_row(
            torch, f"paged_varq {shape}",
            lambda a, c: P.paged_attention_varq_kernel(
                q, a, c, kv_lens, q_lens, sc, meta=meta),
            lambda a, c: P.paged_attention_varq_plain(
                q, a, c, tables, kv_lens, q_lens, sc), sets, tol, 0, 0,
            op_type, shape)
        row.update(bound_ms=b_ms, bound_by=by)
        if not key:
            out.update(row)
            continue
        out.setdefault("extra", {}).update(
            verify_shape=shape, verify_ms=row["t"]["median"],
            verify_plain_ms=row["plain_ms"], verify_bound_ms=b_ms,
            verify_bound_by=by, verify_max_abs_err=row["max_abs_err"])
    return out


# fused optimizer kernels vs plain on the card. f32 buffers (masters,
# moments, f32 parameters): the same ops in the same order (IEEE division
# and square root, no FMA contraction), so only powf and the global
# norm's summation order may differ, by a few ulps. bf16 parameters, cast
# down from the masters: one bf16 ulp where a master sits at a rounding
# boundary. atol is held relative to each buffer's largest magnitude
# (capped at 1): after one clipped step moment2 is ~1e-11 and moment1
# ~1e-5, so an absolute atol would let a kernel that never stores them pass
OPT_TOL = {"float32": dict(atol=1e-6, rtol=1e-5),
           "bfloat16": dict(atol=1e-5, rtol=8e-3)}


def scaled_close(torch, got, want, atol, rtol):
    """``torch.allclose`` with atol times min(1, want's largest finite
    magnitude): each buffer is held at its own size, none more loosely
    than at atol."""
    got, want = got.float(), want.float()
    fin = want[torch.isfinite(want)]
    size = min(1.0, float(fin.abs().max())) if fin.numel() else 1.0
    return torch.allclose(got, want, atol=atol * size, rtol=rtol)


def llama_layer_shapes():
    """One Llama-2-7B decoder layer's weights plus the embedding table."""
    h, f, v = 4096, 11008, 32000
    return [(h, h)] * 4 + [(f, h), (f, h), (h, f), (h,), (h,), (v, h)]


def bert_shapes(torch):
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)
    model = BertForSequenceClassification(BertConfig(num_labels=4),
                                          device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def _opt_copy(torch, dev, shapes, dtype, seed):
    """Parameters, gradients and an AdamW (lr 1e-4, wd 0.1 on matrices,
    global-norm clip 1.0, which the gradients' norm engages) with its
    fused plan, all drawn from ``seed``: two calls give equal copies."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.fused import fused_plan
    g = torch.Generator(device=dev).manual_seed(seed)
    ps = [torch.nn.Parameter((0.02 * torch.randn(s, device=dev, generator=g))
                             .to(dtype)) for s in shapes]
    grads = [(0.01 * torch.randn(s, device=dev, generator=g)).to(dtype)
             for s in shapes]
    opt = AdamW(learning_rate=1e-4, parameters=ps, weight_decay=0.1,
                grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda n: len(shapes[int(n[5:])]) > 1)
    plan = fused_plan(opt, ps, grads)
    check(plan is not None, "the optimizer phase's AdamW did not fuse")
    return ps, grads, opt, plan


def _opt_buffers(ps, opt):
    return [("param", p.detach()) for p in ps] + [
        (k, v) for p in ps for k, v in sorted(opt._state_of(p).items())]


def optimizer_shape(torch, dev, label, shapes, dtype, seed):
    """fused_update and grad_sq_norm against their plain versions for one
    AdamW step on one set of tensors; a second kernel step from an equal
    copy equals the first bit for bit; then times, bounds and the
    library calls. Returns {kernel: row}."""
    from paddle_tpu_torch.kernels import fused_optimizer as fk
    n = sum(math.prod(s) for s in shapes)
    desc = (f"{label}: {len(shapes)} tensors, {n / 1e6:.1f} M parameters, "
            f"{dtype}{' with f32 master weights' if dtype != 'float32' else ''}")
    dt = getattr(torch, dtype)
    runs = []
    for how in ("kernel", "plain", "kernel"):
        ps, grads, opt, plan = _opt_copy(torch, dev, shapes, dt, seed)
        lr = opt._lr_operand(dev)
        if how == "kernel":
            sq, scales = fk.grad_sq_norm(plan.table, grads)
            fk.fused_update(plan.table, grads, lr, scales)
        else:
            sq, scales = fk.grad_sq_norm_plain(plan.table, grads)
            fk.fused_update_plain(plan.table, grads, lr, scales)
        torch.cuda.synchronize()
        runs.append([("sq", sq), ("scales", scales)] + _opt_buffers(ps, opt))
        if how == "plain":
            errs = {}
            for (k, a), (_, b) in zip(runs[0], runs[1]):
                kdt = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
                tol = (dict(atol=0.0, rtol=1e-5) if k in ("sq", "scales")
                       else OPT_TOL[kdt])
                ok = scaled_close(torch, a, b, **tol)
                e = float((a.float() - b.float()).abs().max())
                errs[k] = max(errs.get(k, 0.0), e)
                check(bool(torch.isfinite(a.float()).all()) and ok,
                      f"{desc}: {k} differs from the plain version by {e:.3e}"
                      f" (largest {float(b.float().abs().max()):.3e}; {tol})")
            log(f"  fused optimizer, {desc}: kernel vs plain max_abs_err "
                + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                + f"; global norm {float(sq.sum().sqrt()):.3f}, scale "
                f"{float(scales[0]):.5f}")
            del runs[1][:]
            del ps, grads, opt, plan, sq, scales
            free_card(torch)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(runs[0], runs[2]))
    log(f"  fused optimizer, {desc}: a second kernel step equals the first "
        f"bit for bit: {same}")
    check(same, f"{desc}: two kernel steps from one start differ")
    del runs
    free_card(torch)

    ps, grads, opt, plan = _opt_copy(torch, dev, shapes, dt, seed)
    lr = opt._lr_operand(dev)
    table = plan.table
    sq, scales = fk.grad_sq_norm(table, grads)
    t_upd = time_ms(torch, lambda: fk.fused_update(table, grads, lr, scales),
                    [()])
    t_norm = time_ms(torch, lambda: fk.grad_sq_norm(table, grads), [()])
    p_upd = time_ms(torch, lambda: fk.fused_update_plain(
        table, grads, lr, scales), [()], iters=4, warmup=1)["median"]
    p_norm = time_ms(torch, lambda: fk.grad_sq_norm_plain(table, grads),
                     [()], iters=4, warmup=1)["median"]
    lib_norm = time_ms(torch, lambda: torch._foreach_norm(grads),
                       [()])["median"]
    # torch._fused_adamw_ takes one dtype: the f32 masters (or f32
    # parameters) with f32 gradients, one lr and wd for all
    states = [opt._state_of(p) for p in ps]
    lib_p = [st.get("master_weight", p.detach()) for st, p in zip(states, ps)]
    lib_g = [gr.float() for gr in grads]
    lib_m = [st["moment1"] for st in states]
    lib_v = [st["moment2"] for st in states]
    lib_t = [torch.ones((), device=dev) for _ in ps]
    lib_upd = time_ms(torch, lambda: torch._fused_adamw_(
        lib_p, lib_g, lib_m, lib_v, [], lib_t, lr=1e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.1, eps=1e-8, amsgrad=False,
        maximize=False), [()])["median"]
    gsz = grads[0].element_size()
    psz = ps[0].element_size()
    # update: the gradient, the master (or parameter) and both moments
    # read, those three written and a cast-down parameter where there are
    # masters; ~17 f32 operations per element (clip, decay, moments, bias
    # correction, sqrt, division, update)
    upd_bytes = n * (gsz + 24 + (psz if dtype != "float32" else 0))
    b_upd, by_upd = bound(upd_bytes, 17 * n, "float32")
    b_norm, by_norm = bound(n * gsz, 2 * n, "float32")
    log(f"  fused optimizer, {desc}: fused_update {t_upd['median']:.4f} ms "
        f"(CUPTI {t_upd['cupti']:.4f}, back to back {t_upd['queue']:.4f}), "
        f"bound {b_upd:.4f} ms ({by_upd}, {upd_bytes / 1e9:.2f} GB), plain "
        f"{p_upd:.4f} ms, torch._fused_adamw_ {lib_upd:.4f} ms; grad_sq_norm "
        f"{t_norm['median']:.4f} ms (CUPTI {t_norm['cupti']:.4f}), bound "
        f"{b_norm:.4f} ms, plain {p_norm:.4f} ms, torch._foreach_norm "
        f"{lib_norm:.4f} ms")
    out = {"fused_update": dict(t=t_upd, plain_ms=p_upd, library_ms=lib_upd,
                                bound_ms=b_upd, bound_by=by_upd,
                                shape=desc),
           "grad_sq_norm": dict(t=t_norm, plain_ms=p_norm,
                                library_ms=lib_norm, bound_ms=b_norm,
                                bound_by=by_norm, shape=desc)}
    del ps, grads, opt, plan, table, lib_p, lib_g, lib_m, lib_v, states
    free_card(torch)
    return out, errs


def optimizer_phase(torch, dev, seed):
    """The fused optimizer kernels (``optimizer_shape``) at one Llama-2-7B
    layer's tensors plus the embedding in bf16 with f32 master weights
    (the kernels line's numbers), and at BERT-base's 201 tensors in f32
    (its numbers under ``bert_*`` keys)."""
    llama, e_l = optimizer_shape(torch, dev, "Llama-2-7B layer + embedding",
                                 llama_layer_shapes(), "bfloat16", seed + 11)
    bert, e_b = optimizer_shape(torch, dev, "BERT-base", bert_shapes(torch),
                                "float32", seed + 12)
    norm_keys = ("sq", "scales")
    rows = {}
    for k in ("fused_update", "grad_sq_norm"):
        def worst(errs):
            return max(e for j, e in errs.items()
                       if (j in norm_keys) == (k == "grad_sq_norm"))
        m, b = llama[k], bert[k]
        m["max_abs_err"] = worst(e_l)
        m["extra"] = {"bert_ms": b["t"]["median"],
                      "bert_cupti_ms": b["t"]["cupti"],
                      "bert_bound_ms": b["bound_ms"],
                      "bert_plain_ms": b["plain_ms"],
                      "bert_library_ms": b["library_ms"],
                      "bert_max_abs_err": worst(e_b)}
        rows[k] = m
    return rows


# ------------------------------------------------------------- sampling --

# run 3's draw shapes: a sampled decode step's [B, V] rows, and a verify
# step's [B * Qb, V] families (4 drafts: Qb = 5) with their Qb - 1
# acceptance uniforms per slot
SAMPLE_B, SAMPLE_V, SAMPLE_QB = 4, 32000, 5
# operations per logit of a draw: threefry2x32 (2 + 20 x 3 + 5 x 2 32-bit
# integer ops), the uniform and Gumbel transform (~8 f32 ops, two logf at
# ~20 each) and the add and compare: ~120, counted against the f32 rate
# outside the tensor cores (the table's rate for 32-bit non-tensor work)
DRAW_OPS = 120
DRAW_OPS_U64 = 2 * 72 + 6      # two threefry calls per row, the f64 unit
CHI2_CRIT_15 = 37.697          # chi-square(15 dof) at upper tail 1e-3


def _draw_margin_ulps(torch, ks, logits, seed, ctr, off, row):
    """Row ``row``'s top-2 margin of logits + Gumbel noise (the plain
    version's), in f32 ulps of the top value."""
    k0, k1 = ks.row_keys(seed[row:row + 1].long(), ctr[row:row + 1].long(),
                         None if off is None else off[row:row + 1].long())
    hi, lo = ks._flat_index((logits.shape[1],), logits.device)
    y0, y1 = ks.threefry2x32(k0[:, None], k1[:, None], hi[None], lo[None])
    v = (logits[row] + ks._gumbel_from_bits(y0 ^ y1)[0])
    top = torch.topk(v, 2).values
    ulp = float(torch.nextafter(top[0], torch.tensor(float("inf"),
                                                     device=v.device))
                - top[0])
    return float(top[0] - top[1]) / ulp


def _check_draws(torch, ks, label, logits, seed, ctr, off):
    got = ks.categorical_rows_kernel(logits, seed, ctr, off)
    want = ks.categorical_rows_plain(logits, seed, ctr, off)
    bad = (got != want).nonzero().flatten().tolist()
    for row in bad:
        log(f"  categorical_rows {label}: row {row} kernel {int(got[row])} "
            f"plain {int(want[row])}, top-2 margin "
            f"{_draw_margin_ulps(torch, ks, logits, seed, ctr, off, row):.1f}"
            " f32 ulps")
    log(f"  categorical_rows {label}: {logits.shape[0] - len(bad)} of "
        f"{logits.shape[0]} rows equal the plain version's "
        f"{'ok' if not bad else 'MISMATCH'}")
    check(not bad, f"categorical_rows {label}: kernel tokens differ")
    check(torch.equal(got, ks.categorical_rows_kernel(logits, seed, ctr,
                                                      off)),
          f"categorical_rows {label}: a second launch differs")


def sampling_phase(torch, dev, g):
    """The sampling draw kernels (``csrc/sampling.cu``) against their plain
    version at run 3's shapes, a chi-square test of 20,000 draws, and
    their times; returns the two ``kernels`` rows."""
    from paddle_tpu_torch.kernels import sampling as ks
    b, v, qb = SAMPLE_B, SAMPLE_V, SAMPLE_QB

    def ints(n, lo, hi):
        return torch.randint(lo, hi, (n,), device=dev, generator=g,
                             dtype=torch.int64).to(torch.int32)
    # decode step: processed-logit-like rows (a temperature-scaled spread,
    # a top-k-masked tail at -1e30 in one row), seeds over all of int32
    logits = torch.randn(b, v, device=dev, generator=g) * 2.5
    logits[1, 50:] = NEG
    seed, ctr = ints(b, -2 ** 31, 2 ** 31 - 1), ints(b, 0, 1000)
    _check_draws(torch, ks, f"decode [{b}, {v}] f32", logits, seed, ctr,
                 None)
    # verify step: Qb rows a slot, offsets Qb .. 2 Qb - 1 (the normal
    # draws; the residual family takes 2 Qb .. 3 Qb - 1)
    rows = b * qb
    vlog = torch.randn(rows, v, device=dev, generator=g) * 2.5
    vseed = seed.repeat_interleave(qb)
    vctr = ctr.repeat_interleave(qb)
    for lo in (qb, 2 * qb):
        voff = (torch.arange(qb, device=dev, dtype=torch.int32) + lo) \
            .repeat(b)
        _check_draws(torch, ks, f"verify [{rows}, {v}] f32 offsets {lo}..",
                     vlog, vseed, vctr, voff)
    # acceptance uniforms: (Qb - 1) a slot, offsets 0 .. Qb - 2
    n_u = b * (qb - 1)
    useed = seed.repeat_interleave(qb - 1)
    uctr = ctr.repeat_interleave(qb - 1)
    uoff = torch.arange(qb - 1, device=dev, dtype=torch.int32).repeat(b)
    u = ks.uniform64_rows_kernel(useed, uctr, uoff)
    u_plain = ks.uniform64_rows_plain(useed, uctr, uoff)
    same = torch.equal(u.view(torch.int64), u_plain.view(torch.int64))
    log(f"  uniform64_rows [{n_u}] f64: bit for bit equal to the plain "
        f"version's: {same}")
    check(same, "uniform64_rows differs from its plain version")
    check(bool(((u >= 0) & (u < 1)).all()), "uniform64_rows outside [0, 1)")
    # 20,000 draws of one key sequence (counters 0 .. 19,999) over a fixed
    # 16-way distribution
    n, k = 20000, 16
    p = torch.softmax(torch.linspace(0.0, 3.0, k, device=dev), 0)
    draws = ks.categorical_rows_kernel(
        torch.log(p)[None].expand(n, k).contiguous(),
        torch.full((n,), 1234, dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev))
    obs = torch.bincount(draws.long(), minlength=k).double()
    exp = n * p.double()
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    log(f"  categorical_rows: {n} draws over a 16-way distribution, "
        f"chi-square {chi2:.2f} (15 dof; p > 1e-3 below {CHI2_CRIT_15}) "
        f"{'ok' if chi2 < CHI2_CRIT_15 else 'MISMATCH'}")
    check(chi2 < CHI2_CRIT_15, f"draws fail the chi-square test: {chi2}")

    sets = [(logits,)] + [(torch.randn_like(logits) * 2.5,)
                          for _ in range(3)]
    t = time_ms(torch, lambda a: ks.categorical_rows_kernel(a, seed, ctr),
                sets)
    plain = time_ms(torch, lambda a: ks.categorical_rows_plain(a, seed, ctr),
                    sets)["median"]
    # not the same function (torch's own generator, another stream): the
    # draw a caller without this kernel would make
    multinomial = time_ms(torch, lambda a: torch.multinomial(
        torch.softmax(a, -1), 1), sets)["median"]
    # verify-shape family, beside
    vt = time_ms(torch, lambda a: ks.categorical_rows_kernel(
        a, vseed, vctr, voff), [(vlog,), (torch.randn_like(vlog),)])
    nbytes = logits.numel() * 4 + 3 * b * 4        # logits, seed, ctr, out
    b_ms, by = bound(nbytes, DRAW_OPS * logits.numel(), "float32")
    vb_ms, _ = bound(vlog.numel() * 4 + 4 * rows * 4,
                     DRAW_OPS * vlog.numel(), "float32")
    cat = dict(max_abs_err=0.0, t=t, plain_ms=plain, library_ms=None,
               bound_ms=b_ms, bound_by=by, shape=f"logits[{b}, {v}] f32",
               extra={"multinomial_ms": multinomial,
                      "verify_ms": vt["median"], "verify_cupti_ms":
                      vt["cupti"], "verify_bound_ms": vb_ms})
    log(f"  torch.multinomial(softmax(l)) at [{b}, {v}] (another stream): "
        f"{multinomial:.4f} ms; categorical_rows at the verify shape "
        f"[{rows}, {v}]: {vt['median']:.4f} ms (CUPTI {vt['cupti']:.4f}), "
        f"bound {vb_ms:.4f} ms")
    usets = [(useed, uctr, uoff)]
    ut = time_ms(torch, lambda s, c, o: ks.uniform64_rows_kernel(s, c, o),
                 usets)
    uplain = time_ms(torch, lambda s, c, o: ks.uniform64_rows_plain(s, c, o),
                     usets)["median"]
    ub_ms, uby = bound(3 * n_u * 4 + 8 * n_u, DRAW_OPS_U64 * n_u, "float32")
    uni = dict(max_abs_err=float((u - u_plain).abs().max()), t=ut,
               plain_ms=uplain, library_ms=None, bound_ms=ub_ms,
               bound_by=uby, shape=f"[{n_u}] f64")
    return {"categorical_rows": cat, "uniform64_rows": uni}


# BERT-base attention: batch 16 x 128, 12 heads of 64, a key-padding
# mask of row lengths 32..128, dropout 0.1
BERT_ATTN = dict(b=16, s=128, h=12, d=64, p=0.1)


def dropout_phase(torch, dev, g):
    """The three flash kernels with attention dropout against their plain
    versions at the BERT-base fine-tuning shape (f32 and bf16, additive
    key mask, p 0.1, one fixed seed pair); the pattern's keep rate over
    the unmasked entries within 6 binomial standard deviations of 0.9;
    the f32 kernels timed with and without dropout (and SDPA with
    dropout as the yardstick), logged."""
    from paddle_tpu_torch.kernels import attention as A
    F = torch.nn.functional
    b, s, h, d, p = (BERT_ATTN[k] for k in ("b", "s", "h", "d", "p"))
    seeds = (-1234567891, 987654321)
    lens = torch.randint(32, s + 1, (b,), device=dev, generator=g)
    keys = torch.arange(s, device=dev)[None, :] < lens[:, None]
    mask = ((1.0 - keys.float()) * -1e4)[:, None, None, :].contiguous()
    rows = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
    keep = A.dropout_keep_mask(torch.arange(s, device=dev)[:, None],
                               torch.arange(s, device=dev)[None, :], rows,
                               seeds[0], seeds[1], p)
    valid = keys[:, None, None, :].expand(b, h, s, s)
    n = int(valid.sum())
    rate = float(keep[valid].float().mean())
    sd = (p * (1 - p) / n) ** 0.5
    log(f"dropout keep rate over {n} unmasked entries: {rate:.5f} "
        f"(1 - p = {1 - p}, 6 sd = {6 * sd:.5f})")
    check(abs(rate - (1 - p)) <= 6 * sd, "dropout keep rate off 1 - p")
    sc = d ** -0.5
    drop = dict(dropout_p=p, seeds=seeds)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=g).to(dt)
                       for _ in range(4))
        out, lse = A.flash_attention_kernel(q, k, v, sc, False, mask, **drop)
        name = f"{dtype} q[{b}, {s}, {h}, {d}] key mask, dropout {p}"
        compare(torch, f"flash_fwd {name}", out,
                A.flash_attention_plain(q, k, v, sc, False, mask, **drop),
                dtype)
        plain0 = A.flash_attention_plain(q, k, v, sc, False, mask)
        check(not torch.allclose(out.float(), plain0.float(), **TOL[dtype]),
              "flash_fwd with dropout gives the output without it")
        got = A.flash_attention_bwd_kernel(q, k, v, out, lse, do, sc, False,
                                           mask, **drop)
        want = A.flash_attention_bwd_plain(q, k, v, out, lse, do, sc, False,
                                           mask, **drop)
        for w, a, r in zip(("dq", "dk", "dv"), got, want):
            compare(torch, f"flash_bwd_{w} {name}", a, r, dtype)
    # f32 timings at this shape, with and without dropout
    def inputs():
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=g)
                       for _ in range(4))
        out, lse = A.flash_attention_kernel(q, k, v, sc, False, mask, **drop)
        return q, k, v, do, lse, A.bwd_delta(out, do)
    sets = [inputs() for _ in range(4)]
    times = {}
    for label, kw in (("p=0", {}), (f"p={p}", drop)):
        times[label] = {
            "flash_fwd": time_ms(torch, lambda q_, k_, v_, *_:
                                 A.flash_attention_kernel(
                                     q_, k_, v_, sc, False, mask, **kw),
                                 sets)["median"],
            "flash_bwd_dkdv": time_ms(torch, lambda q_, k_, v_, do_, l_, dl_:
                                      A.flash_bwd_dkdv_kernel(
                                          q_, k_, v_, do_, l_, dl_, sc,
                                          False, mask, **kw),
                                      sets)["median"],
            "flash_bwd_dq": time_ms(torch, lambda q_, k_, v_, do_, l_, dl_:
                                    A.flash_bwd_dq_kernel(
                                        q_, k_, v_, do_, l_, dl_, sc, False,
                                        mask, **kw), sets)["median"]}
    sdpa = time_ms(torch, lambda q_, k_, v_, *_: F.scaled_dot_product_attention(
        q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
        attn_mask=mask, dropout_p=p, scale=sc), sets)["median"]
    for label, t in times.items():
        log(f"  BERT-shape f32 q[{b}, {s}, {h}, {d}] key mask, {label}: "
            + ", ".join(f"{k} {ms:.4f} ms" for k, ms in t.items()))
    log(f"  SDPA forward with dropout {p} at that shape: {sdpa:.4f} ms")


def lookup_prompt(torch, model, dev, toks, seg_len, reps, m, rounds=8,
                  tries=4, **kw):
    """``reps`` copies of a random ``seg_len``-token segment, the first
    ``m`` tokens of the last copy (the lead) replaced by the model's own
    greedy continuation of the prompt. When the first generated token
    equals the lead's first, prompt lookup matches the segment's last
    tokens at the start of the last copy and drafts the rest of the lead;
    the drafts the model accepts are the lead's tokens its continuation
    repeats. The continuation changes with the lead it replaces (a
    random-weight model's logits are nearly flat), so the lead is
    recomputed up to ``rounds`` times. When no continuation repeated even
    the lead's first token (so no draft would be proposed), the search
    starts over from a fresh segment and lead, up to ``tries`` searches;
    a later search replaces only the lead's first token while none
    repeats (the smallest change to the prompt, so the continuation's
    first token, which prompt lookup matches, is the likeliest to stay).
    The prompt whose continuation repeats the most of its lead is
    returned, at once when that is at least 2 tokens (one accepted
    draft). Callers read the stats. ``kw`` is the predictor configuration
    the continuation is computed with."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    cb = ContinuousBatchingPredictor(model, device=dev,
                                     enable_prefix_cache=False, **kw)
    best = (-1, None)
    for t in range(1, tries + 1):
        seg, lead = toks(seg_len), toks(m)
        for r in range(1, rounds + 1):
            p = seg * (reps - 1) + lead + seg[m:]
            y = cb.generate([p], max_new_tokens=m)[0]
            k = next((i for i, (a, b) in enumerate(zip(y, lead)) if a != b),
                     m)
            best = max(best, (k, p), key=lambda kp: kp[0])
            if k >= 2:
                break
            lead = y if t == 1 or k else y[:1] + lead[1:]
        if best[0] >= 1:
            break
    log(f"lookup prompt ({reps} x {seg_len} tokens): after {t} searches "
        f"and {r} rounds in the last the continuation repeats {best[0]} of "
        f"its {m}-token lead")
    del cb
    torch.cuda.empty_cache()
    return best[1]


# ---------------------------------------------------- full-width checks --

def f32_parity_phase(torch, dev, seed):
    """2-layer Llama-2-7B-width f32 model: card (kernels) vs CPU (plain
    versions) on the same weights."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    s = 64
    lens = torch.tensor([64, 37])
    gen = torch.Generator().manual_seed(seed + 1)
    ids = torch.randint(1, cfg.vocab_size, (2, s), generator=gen)
    pos = torch.zeros(2, s, dtype=torch.long)
    for i, L in enumerate(lens.tolist()):
        ids[i, :s - L] = 0
        pos[i, s - L:] = torch.arange(L)
    mask, key_valid = prefill_mask(torch, "cpu", lens, s)
    with torch.no_grad():
        want = cpu(ids, attn_mask=mask, position_ids=pos)
        got = gpu(ids.to(dev), attn_mask=mask.to(dev),
                  position_ids=pos.to(dev)).cpu()
    check(bool(torch.isfinite(got).all()), "f32 prefill logits non-finite")
    err = float((got[key_valid] - want[key_valid]).abs().max())
    ok = torch.allclose(got[key_valid], want[key_valid], **LOGIT_TOL)
    log(f"f32 2-layer full-width prefill logits, card vs CPU: max_abs_err="
        f"{err:.3e} (atol={LOGIT_TOL['atol']}, rtol={LOGIT_TOL['rtol']}) "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, "f32 prefill logits differ between kernels and plain path")
    prompts = [ids[0, :].tolist()[-40:], ids[1, -37:].tolist(),
               ids[0, -21:].tolist()]
    geom = dict(max_batch_size=2, page_size=16, max_seq_len=128)
    toks_gpu = ContinuousBatchingPredictor(gpu, device=dev, **geom).generate(
        prompts, max_new_tokens=6)
    toks_cpu = ContinuousBatchingPredictor(cpu, device="cpu",
                                           **geom).generate(
        prompts, max_new_tokens=6)
    log(f"f32 2-layer greedy tokens, card == CPU: {toks_gpu == toks_cpu}")
    check(toks_gpu == toks_cpu,
          f"greedy tokens differ: card {toks_gpu} vs CPU {toks_cpu}")
    # chunked prefill + speculation + ragged decode are lossless: the
    # same greedy tokens as the block-table unchunked configuration on
    # the card, and as themselves on the CPU (plain versions). A
    # 100-token prompt is chunked (chunk 64); a lookup prompt (a 16-token
    # segment four times, its last copy led by the model's continuation)
    # gives the drafter matches. The gate needs drafts both accepted and
    # rejected, so committed drafts and the rollback of rejected
    # positions run through paged_varq: up to 8 lookup prompts are tried.
    geom = dict(max_batch_size=2, page_size=16, max_seq_len=256)
    new = dict(use_ragged=True, prefill_chunk_tokens=64, spec_draft_tokens=4)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    for attempt in range(1, 9):
        prompts = [toks(100), ids[1, -37:].tolist(),
                   lookup_prompt(torch, gpu, dev, toks, 16, 4, 8,
                                 use_ragged=False, **geom)]
        card = ContinuousBatchingPredictor(gpu, device=dev, **geom, **new)
        toks_new = card.generate(prompts, max_new_tokens=12)
        st = card.stats
        log(f"f32 lookup prompt {attempt}: drafts accepted "
            f"{st['spec_accepted']} of {st['spec_proposed']}")
        if 0 < st["spec_accepted"] < st["spec_proposed"]:
            break
    check(0 < st["spec_accepted"] < st["spec_proposed"],
          f"no lookup prompt gave both accepted and rejected drafts: {st}")
    base = ContinuousBatchingPredictor(gpu, device=dev, use_ragged=False,
                                       **geom).generate(prompts,
                                                        max_new_tokens=12)
    cpu_new = ContinuousBatchingPredictor(cpu, device="cpu", **geom, **new)
    toks_cpu = cpu_new.generate(prompts, max_new_tokens=12)
    log(f"f32 2-layer greedy tokens, ragged + chunked (64) + speculative "
        f"(4) vs block-table unchunked on the card: {toks_new == base}; "
        f"vs the same configuration on the CPU: {toks_new == toks_cpu}; "
        f"card stats {st}")
    check(toks_new == base, f"chunked/speculative tokens {toks_new} differ "
          f"from the plain configuration's {base}")
    check(toks_new == toks_cpu,
          f"chunked/speculative tokens differ: card {toks_new} vs CPU "
          f"{toks_cpu}")
    check(st == cpu_new.stats, f"stats differ: card {st} vs CPU "
          f"{cpu_new.stats}")
    check(st["chunked_requests"] == 1, f"the f32 check did not chunk: {st}")
    f1_gate(torch, dev, gpu, prompts[:2], seed, "eager")
    return err


def f1_gate(torch, dev, model, prompts, seed, label, pred=None):
    """A weight change between two serves flushes the prefix cache: the
    prompts served (on ``pred``, else a new predictor), every weight
    changed in place, the prompts served again: no prefix hit, and a
    fresh eager predictor's tokens on the new weights."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    geom = dict(max_batch_size=2, page_size=16, max_seq_len=128)
    cb = pred or ContinuousBatchingPredictor(model, device=dev, **geom)
    cb.generate(prompts, max_new_tokens=6)
    hits = cb.stats["prefix_hits"] + cb.stats["prefix_partial_hits"]
    perturb_in_place(torch, model, seed + 7)
    got = cb.generate(prompts, max_new_tokens=6)
    want = ContinuousBatchingPredictor(model, device=dev, **geom).generate(
        prompts, max_new_tokens=6)
    again = cb.stats["prefix_hits"] + cb.stats["prefix_partial_hits"]
    log(f"f32 F1 gate ({label}): after an in-place weight change, tokens "
        f"== a fresh predictor's: {got == want}; prefix hits in the second "
        f"serve {again - hits}")
    check(got == want and again == hits,
          f"{label}: a weight change left the prefix cache stale")


# kernels each served run must launch (the ragged run decodes through
# ragged_decode and runs its chunks and verify spans through paged_varq)
RUN1_KERNELS = ("rms_norm", "flash_fwd", "paged_decode")
RUN2_KERNELS = ("rms_norm", "flash_fwd", "ragged_decode", "paged_varq")
RUN1 = dict(use_ragged=False)
RUN2 = dict(use_ragged="auto", prefill_chunk_tokens=256, spec_draft_tokens=4)
GEOM = dict(max_batch_size=4, page_size=16, max_seq_len=1024)
TRAIN_KERNELS = ("rms_norm", "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                 "fused_update", "grad_sq_norm")
# decoder layers of the trained model, of 32: AdamW with f32 master
# weights keeps 16 bytes per parameter, 108 GB for all 32 layers
TRAIN_LAYERS = 8
# decoder layers of serve run F16, of 32: its eager run is host-bound,
# so its time grows with the depth; 16 keeps the whole script well
# inside its time limit
F16_LAYERS = 16


def free_card(torch):
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase(torch, dev, seed, layers, card):
    """The three served runs on one model; returns each run's launch
    counts and, for the aot phase, the model, the prompts and each run's
    eager results."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers, dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    log(f"serve: Llama-2-7B widths (hidden {cfg.hidden_size}, heads "
        f"{cfg.num_attention_heads}/{cfg.num_key_value_heads}, "
        f"intermediate {cfg.intermediate_size}, vocab {cfg.vocab_size}), "
        f"{layers} of 32 layers, bf16, random weights (seed {seed}) built "
        f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(seed + 2)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    shared = toks(8 * 16 + 5)           # 8 full pages + a partial page
    prompts = [toks(512), toks(48), shared, toks(32), toks(300),
               shared + toks(91), toks(200), toks(130)]
    max_new = [64, 40, 48, 32, 56, 48, 36, 60]
    t0 = time.perf_counter()
    run1 = serve_run(torch, dev, model, cfg, prompts, max_new, card,
                     "run 1 (block-table decode)", RUN1_KERNELS, RUN1)
    run1.update(serve_profile(torch, dev, model, prompts[:4], card, RUN1))
    run1["tick"] = tick_launches(torch, dev, run1.pop("cb"), card,
                                 "run 1")
    outs1 = run1["outs"]
    log(f"serve run 1 took {time.perf_counter() - t0:.1f} s")

    # run 2: two lookup prompts that repeat a 64-token segment five times,
    # the last copy led by 16 tokens of the model's own continuation, so
    # that the prompt-lookup drafter has matches the model may accept;
    # 512, 300 and both 320-token prompts exceed the 256-token chunk
    # threshold
    reps = [lookup_prompt(torch, model, dev, toks, 64, 5, 16, **GEOM,
                          **dict(RUN2, spec_draft_tokens=0))
            for _ in range(2)]
    t0 = time.perf_counter()
    run2 = serve_run(
        torch, dev, model, cfg, prompts + reps, max_new + [64, 64], card,
        "run 2 (ragged decode, chunked prefill 256, 4 drafts)",
        RUN2_KERNELS, RUN2)
    cb, outs2 = run2.pop("cb"), run2["outs"]
    st = cb.stats
    check(cb.use_ragged, "use_ragged='auto' did not turn on on CUDA")
    check(st["chunked_requests"] >= 3, f"fewer than 3 chunked requests: {st}")
    check(st["mixed_steps"] > 0 and st["spec_proposed"] > 0,
          f"no mixed step or no drafts: {st}")
    same = sum(a == b for a, b in zip(outs1, outs2))
    # index of the first token where run 2 leaves run 1 (bf16 rounds at
    # other places in the two decode kernels and in chunked prefill)
    split = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  min(len(a), len(b))) for a, b in zip(outs1, outs2)]
    log(f"serve run 2: draft acceptance {st['spec_accepted']} / "
        f"{st['spec_proposed']} = "
        f"{st['spec_accepted'] / max(st['spec_proposed'], 1):.3f}; "
        f"{same} of {len(outs1)} requests' bf16 tokens equal run 1's; "
        f"first differing token per request {split}")
    run2.update(serve_profile(torch, dev, model, [prompts[0], prompts[1],
                                                  reps[0], prompts[3]],
                              card, RUN2))
    log(f"serve run 2 took {time.perf_counter() - t0:.1f} s")
    del cb
    free_card(torch)
    t0 = time.perf_counter()
    run3 = serve_run3(torch, dev, model, cfg, prompts + reps,
                      max_new + [64, 64], card, outs2, run2["tok_s"])
    log(f"serve run 3 took {time.perf_counter() - t0:.1f} s")
    return {"model": model, "prompts": prompts, "reps": reps,
            "max_new": max_new, "runs": [run1, run2, run3]}


# run 3: run 2's configuration and prompts with sampling on; per request
# None (greedy) or the SamplingParams fields. Greedy: the 512-token prompt
# (chunked while sampled slots decode, so they pause), the shared prefix
# and its extension (which takes the prefix cache's suffix prefill; sampled
# requests bypass the cache); both lookup prompts (8, 9) sampled, so
# sampled slots draft and verify; the 300-token prompt sampled and chunked,
# so its first token comes by replay after its final chunk
RUN3 = dict(RUN2, sampling_enabled=True)
SAMPLING_KERNELS = ("categorical_rows", "uniform64_rows")
RUN3_KERNELS = RUN2_KERNELS + SAMPLING_KERNELS
_A = dict(temperature=0.8, top_k=50, top_p=0.95)
_B = dict(temperature=1.0)
_D = dict(temperature=0.6, top_p=0.9)
RUN3_MIX = [None, _A, None, _B, _D, None, _A, _B, _A, _D]
# run 3's profiled pass: the 512-token prompt (greedy, chunked), a
# sampled short prompt, a sampled lookup prompt, another sampled prompt
RUN3_PICK = (0, 1, 8, 3)


def run3_sampling(seed_of=None):
    from paddle_tpu_torch.generation.sampling import SamplingParams
    seed_of = seed_of or {}
    return [None if kw is None else
            SamplingParams(seed=seed_of.get(r, 11 + r), **kw)
            for r, kw in enumerate(RUN3_MIX)]


def serve_run3(torch, dev, model, cfg, prompts, max_new, card, outs2,
               tok_s2):
    """Serve run 3: greedy and sampled requests through one
    sampling-enabled predictor, checked (a)-(e); returns its launch
    counts."""
    label = "run 3 (run 2 + sampling: 3 greedy, 7 sampled)"
    sp = run3_sampling()
    res = serve_run(torch, dev, model, cfg, prompts, max_new, card, label,
                    RUN3_KERNELS, RUN3, sp)
    outs, counts, cb, tok_s = (res["outs"], res["counts"], res.pop("cb"),
                               res["tok_s"])
    ss = cb.sampling_stats
    log(f"serve run 3: sampling stats {ss}")
    log(f"serve run 3 on {card}: decode {tok_s:.1f} tok/s outside "
        f"monolithic prefill; run 2 {tok_s2:.1f} tok/s")
    # (a) the same run again gives the same tokens
    again = run3_predictor(model, dev).generate(
        prompts, max_new_tokens=max_new, sampling=sp)
    diff = [r for r, (x, y) in enumerate(zip(outs, again)) if x != y]
    log(f"serve run 3 (a): repeated, requests with other tokens {diff}")
    check(not diff, f"run 3 repeated gives other tokens for {diff}")
    # (b) all greedy on this sampling-enabled predictor: run 2's tokens
    greedy = run3_predictor(model, dev).generate(
        prompts, max_new_tokens=max_new)
    diff = [r for r, (x, y) in enumerate(zip(greedy, outs2)) if x != y]
    log(f"serve run 3 (b): all greedy with sampling enabled vs run 2, "
        f"requests with other tokens {diff}")
    check(not diff, f"greedy on the sampling predictor differs from run 2 "
          f"for {diff}")
    # run 3's own greedy requests share their batches with sampled ones
    # (other prefill groups, replay and paused ticks, other chunk sizes),
    # so bf16 rounds at other places than in run 2: logged, not checked
    split = {r: next((i for i, (x, y) in enumerate(zip(outs[r], outs2[r]))
                      if x != y), len(outs[r]))
             for r, kw in enumerate(RUN3_MIX) if kw is None}
    log(f"serve run 3: per greedy request, the index of its first token "
        f"that differs from run 2's (its length where none does) {split}")
    # (c) another seed for one sampled request changes its tokens
    r_c = 1
    other = run3_predictor(model, dev).generate(
        prompts, max_new_tokens=max_new,
        sampling=run3_sampling({r_c: 1000 + r_c}))
    log(f"serve run 3 (c): request {r_c} with seed {1000 + r_c}: tokens "
        f"{'differ' if other[r_c] != outs[r_c] else 'EQUAL'}")
    check(other[r_c] != outs[r_c], "another seed gave the same tokens")
    # (d) sampled requests, a paused sampled slot, sampled drafts
    check(ss["sampled_requests"] == sum(kw is not None for kw in RUN3_MIX),
          f"not every sampled request was admitted as sampled: {ss}")
    check(ss["paused_slots"] > 0 and cb.stats["mixed_steps"] > 0,
          f"no mixed step paused a sampled slot: {ss}")
    check(ss["sampled_spec_proposed"] > 0, f"no sampled drafts: {ss}")
    # (e) both draw kernels ran in the counted run (serve_run checked
    # RUN3_KERNELS)
    log(f"serve run 3 (e): categorical_rows {counts['categorical_rows']}, "
        f"uniform64_rows {counts['uniform64_rows']} launches")
    res["tick"] = tick_launches(torch, dev, cb, card, "run 3")
    # a profiled pass: the 512-token prompt (greedy, chunked), a sampled
    # short prompt, a sampled lookup prompt and another sampled prompt
    res.update(serve_profile(torch, dev, model, [prompts[r] for r in RUN3_PICK],
                             card, RUN3, [sp[r] for r in RUN3_PICK]))
    return res


def run3_predictor(model, dev):
    """A fresh predictor of run 3's configuration."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    return ContinuousBatchingPredictor(model, device=dev, **GEOM, **RUN3)


def tick_launches(torch, dev, cb, card, label):
    """Device activities (kernels, copies, memsets) of one decode tick of
    ``cb``, from the profiler, dispatched through its ``_jit_call``: the
    eager steps without an engine, a replayed graph with one. Every slot
    decodes one token over the trash page. A sampling-enabled predictor's
    tick is the sampled one (operands for 2 of 4 sampled slots), which
    must launch the draw kernel once; without an engine it also gives the
    greedy tick (the same inputs) and the draw alone, kernel and plain.
    Returns {"greedy" / "sampled": activities per tick}."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.kernels import (launch_counts, reset_launch_counts,
                                          sampling as ks)
    from paddle_tpu_torch.kernels.paged_attention import RaggedMetaBuilder
    b, pps = cb.B, cb.pages_per_seq
    tables = np.full((b, pps), cb._trash, np.int32)
    args = (cb._put(tables), cb._put(np.ones(b, np.int32)),
            cb._put(np.arange(b, dtype=np.int32) + 5))
    meta = None
    if cb.use_ragged:
        builder = RaggedMetaBuilder(b, pps, cb.page, cb._trash)
        for i in range(b):
            builder.set_slot(i, tables[i], 2)
        meta = cb._put(builder.stacked())
    samp = tuple(cb._put(a) for a in (
        np.asarray([0.0, 0.8, 0.0, 0.6], np.float32),
        np.asarray([0, 50, 0, 0], np.int32),
        np.asarray([1.0, 0.95, 1.0, 0.9], np.float32),
        np.arange(b, dtype=np.int32), np.zeros(b, np.int32)))
    meta_sig = cb._meta_sig(meta)

    def greedy():
        return cb._jit_call(("decode", tables.shape, meta_sig),
                            cb._raw_decode_step, *args, meta)

    def sampled():
        return cb._jit_call(("decode_sample", tables.shape, meta_sig),
                            cb._raw_decode_sample_step, *args, samp, meta)

    def count(fn, reps=1):
        """(activities, device ms) per call over ``reps`` calls, and
        whether a kernel named like the draw kernel was traced."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = device_kernel_ms(torch, prof)
        return (sum(n for _, n in kern.values()) / reps,
                sum(ms for ms, _ in kern.values()) / reps,
                any("categorical" in k for k in kern))
    how = "replayed graph" if cb._engine is not None else "eager"
    layers = cb.model.config.num_hidden_layers
    out = {}
    if not cb.sampling_enabled or cb._engine is None:
        g = count(greedy)
        out["greedy"] = g[0]
        log(f"serve {label} on {card}: device activities per greedy decode "
            f"tick ({how}, profiler, {layers} layers): {g[0]:.0f} "
            f"({g[1]:.3f} ms of device time)")
    if not cb.sampling_enabled:
        return out
    smp = count(sampled)
    out["sampled"] = smp[0]
    reset_launch_counts()
    sampled()
    draws = dict(launch_counts)
    log(f"serve {label} on {card}: device activities per sampled decode "
        f"tick ({how}): {smp[0]:.0f} ({smp[1]:.3f} ms; the draw kernel in "
        f"the trace: {smp[2]}; launch counts: categorical_rows "
        f"{draws['categorical_rows']}, uniform64_rows "
        f"{draws['uniform64_rows']})")
    check(draws["categorical_rows"] == 1 and draws["uniform64_rows"] == 0,
          f"a sampled decode tick did not draw in one launch: {draws}")
    if cb._engine is None:
        lg = torch.randn(b, cb.model.config.vocab_size, device=dev)
        seed, ctr = samp[3], samp[4]
        kernel = count(lambda: ks.categorical_rows_kernel(lg, seed, ctr), 10)
        plain = count(lambda: ks.categorical_rows_plain(lg, seed, ctr))
        log(f"serve {label} on {card}: the draw alone: kernel "
            f"{kernel[0]:.1f} ({kernel[1]:.4f} ms, over 10 calls), plain "
            f"threefry ops {plain[0]:.0f} ({plain[1]:.4f} ms)")
    return out


def time_prefills(cb):
    """Wrap ``cb``'s two prefill entry points (each ends in a host sync)
    to sum their wall time into the returned one-element list, until
    ``untime_prefills(cb)``."""
    prefill_s = [0.0]

    def timed(fn):
        def run(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                prefill_s[0] += time.perf_counter() - t
        return run
    cb._batch_prefill = timed(cb._batch_prefill)
    cb._suffix_prefill = timed(cb._suffix_prefill)
    return prefill_s


def untime_prefills(cb):
    del cb._batch_prefill, cb._suffix_prefill


def serve_run(torch, dev, model, cfg, prompts, max_new, card, label,
              required, kw, sampling=None, cb=None):
    """One counted serve (on ``cb``, else on a new predictor of ``kw``):
    launch counters set to 0 just before it and read just after; every
    kernel in ``required`` must have launched. Returns {"outs", "counts",
    "stats", "cb", "tok_s": decode tokens/s outside monolithic prefill,
    "ttft_p50_ms", "peak_gib", "dtype_counts": launches per (kernel, q
    dtype, K/V dtype)}."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    from paddle_tpu_torch.kernels import (dtype_launch_counts, launch_counts,
                                          reset_launch_counts)
    if cb is None:
        cb = ContinuousBatchingPredictor(model, device=dev, **GEOM, **kw)
    prefill_s = time_prefills(cb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = cb.generate(prompts, max_new_tokens=max_new, sampling=sampling)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    dtype_counts = dict(dtype_launch_counts)
    untime_prefills(cb)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"serve {label}: status {cb.last_status}; stats {cb.stats}")
    log(f"serve {label}: kernel launches {counts}")
    check(cb.last_status == ["ok"] * len(prompts), "a request did not end ok")
    check([len(o) for o in outs] == max_new, "wrong number of new tokens")
    check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
          "token id out of range")
    check(all(counts[k] > 0 for k in required),
          f"a kernel of {label} was never launched in it: {counts}")
    check(cb.stats["prefix_partial_hits"] >= 1,
          "the shared prefix did not take the suffix-prefill path")
    log(f"serve {label}: TTFT per request (ms, from the generate call): "
        + ", ".join(f"{t * 1e3:.1f}" for t in cb.last_ttft_s))
    n_tok = sum(len(o) for o in outs)
    dec_tok = n_tok - len(outs)         # first tokens come from prefill
    ttft = sorted(cb.last_ttft_s)
    dec_s = max(wall - prefill_s[0], 1e-9)
    log(f"serve {label} on {card}: TTFT p50 "
        f"{statistics.median(ttft) * 1e3:.1f} ms, max {ttft[-1] * 1e3:.1f} "
        f"ms; {n_tok} new tokens in {wall:.2f} s ({n_tok / wall:.1f} tok/s "
        f"overall); decode {dec_tok} tokens in {dec_s:.2f} s outside "
        f"monolithic prefill ({dec_tok / dec_s:.1f} tok/s, "
        f"{cb.stats['decode_steps']} steps); peak memory "
        f"{peak / 2**30:.2f} GiB")
    return {"outs": outs, "counts": counts, "dtype_counts": dtype_counts,
            "stats": dict(cb.stats),
            "sampling_stats": dict(cb.sampling_stats), "cb": cb,
            "tok_s": dec_tok / dec_s,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "peak_gib": peak / 2**30}


def serve_profile(torch, dev, model, prompts, card, kw, sampling=None,
                  cb=None):
    """A profiled serve of 4 requests (after the counted run, so the
    tracer's cost stays out of its numbers; on ``cb`` with its prefix
    cache emptied, else on a new predictor of ``kw``): device busy and
    idle share, host ops per decode step, and the device time by kernel.
    Returns {"idle", "host_per_step"}."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    if cb is None:
        cb = ContinuousBatchingPredictor(model, device=dev, **GEOM, **kw)
    elif cb.prefix_cache is not None:
        cb.prefix_cache.clear(cb.pool)
    steps0 = dict(cb.stats)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cb.generate(prompts, max_new_tokens=32, sampling=sampling)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernel_ms(torch, prof)
    busy = sum(ms for ms, _ in kern.values())
    st = {k: cb.stats[k] - steps0[k] for k in steps0}
    how = "replayed graphs" if cb._engine is not None else "eager"
    log(f"serve profile {kw} ({how}) on {card}: {len(prompts)} requests "
        f"({[len(p) for p in prompts]} prompt tokens) x 32 tokens, "
        f"{st['decode_steps']} steps ({st['mixed_steps']} mixed, "
        f"{st['spec_ticks']} speculative), wall {wall:.1f} ms "
        f"(traced), device busy {busy:.1f} ms, idle share "
        f"{1 - busy / wall:.3f}")
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<6d} {name[:90]}")
    from torch.autograd import DeviceType
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    calls = sum(e.count for e in host)
    log(f"serve profile: host ops {host_ms:.1f} ms of self time "
        f"({calls} calls, {calls / max(st['decode_steps'], 1):.0f} per "
        f"decode step); top by self time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"  {e.self_cpu_time_total / 1e3:9.2f} ms x{e.count:<6d} "
            f"{e.key[:60]}")
    return {"idle": 1 - busy / wall,
            "host_per_step": calls / max(st["decode_steps"], 1)}


# ------------------------------------------- f16 and kv_dtype serving --

# serve run KV: the bf16 serve model over an f32 KV pool, run 2's traffic
# through block-table decode (then a short ragged pass), so decode, the
# chunked mixed step, verify and the shared prefix's suffix prefill all
# read f32 pages with bf16 queries
RUN_KV = dict(use_ragged=False, prefill_chunk_tokens=256, spec_draft_tokens=4,
              kv_dtype="float32")
KV_KERNELS = ("flash_fwd", "paged_decode", "paged_varq")
# serve run F16: Llama-2-7B widths in float16 (its own seeded init), the
# pool in the default (the weights') dtype, run 3's traffic and
# configuration
F16_KERNELS = ("rms_norm", "flash_fwd", "ragged_decode", "paged_varq")


def draft_check(torch, dev, model, toks, kw, label, tries=8):
    """A lookup prompt (4 x 16 tokens, an 8-token lead) searched and then
    served alone, greedy, on a predictor of ``kw``'s configuration with 4
    drafts, up to ``tries`` prompts, until its drafts are both accepted
    and rejected: the verify step then commits drafts and rolls rejected
    positions back on the model's pages. A 2-layer model's continuation
    repeats its lead; at 32 layers the search finds none that repeats
    more than the lead's first token (serve runs 2-3 and F16: no draft
    accepted). Returns the run's stats."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    for attempt in range(1, tries + 1):
        p = lookup_prompt(torch, model, dev, toks, 16, 4, 8, **kw)
        cb = ContinuousBatchingPredictor(model, device=dev,
                                         enable_prefix_cache=False, **kw,
                                         spec_draft_tokens=4)
        cb.generate([p], max_new_tokens=12)
        st = cb.stats
        log(f"{label}: lookup prompt {attempt} alone, drafts accepted "
            f"{st['spec_accepted']} of {st['spec_proposed']}")
        if 0 < st["spec_accepted"] < st["spec_proposed"]:
            return st
    check(False, f"{label}: no lookup prompt saw drafts both accepted and "
          "rejected")


def dtype_launches(counts, kernels, qd, kd):
    """{kernel: launches of its (qd, kd) instance} from a run's
    ``dtype_counts``."""
    return {k: counts.get((k, qd, kd), 0) for k in kernels}


def serve_kv_run(torch, dev, serve, card):
    """Serve run KV on the serve phase's bf16 model with
    ``kv_dtype="float32"``: every request ok, the pool's bytes those of
    f32 pages, and flash_fwd (the suffix prefill: cached f32 pages
    concatenated with the suffix's bf16 K/V promote to f32), paged_decode
    and paged_varq launched with (bf16 q, f32 pages); then run 1's
    prompts 2-6 (the shared prefix's extension among them) through ragged
    decode over f32 pages, 16 new tokens each. Returns the two
    runs' per-instance launch counts and the counted run's numbers."""
    model, cfg = serve["model"], serve["model"].config
    prompts = serve["prompts"] + serve["reps"]
    max_new = serve["max_new"] + [64, 64]
    t0 = time.perf_counter()
    res = serve_run(torch, dev, model, cfg, prompts, max_new, card,
                    "run KV (bf16 model, float32 KV pool, block-table "
                    "decode, chunked prefill 256, 4 drafts)", KV_KERNELS,
                    RUN_KV)
    cb = res.pop("cb")
    st, pool = cb.stats, cb.pool
    got = dtype_launches(res["dtype_counts"], KV_KERNELS, "bfloat16",
                         "float32")
    want_bytes = (2 * cfg.num_hidden_layers * pool.num_pages * pool.page_size
                  * pool.n_kv_heads * pool.head_dim * 4)
    have = sum(t.numel() * t.element_size() for t in pool.k + pool.v)
    log(f"serve run KV: pool {pool.dtype}, {have / 2**30:.2f} GiB (2 x "
        f"{cfg.num_hidden_layers} layers x {pool.num_pages} pages x "
        f"{pool.page_size} x {pool.n_kv_heads} x {pool.head_dim} x 4 bytes "
        f"= {want_bytes / 2**30:.2f} GiB); launches with (bfloat16 q, "
        f"float32 pages) {got}; drafts accepted {st['spec_accepted']} of "
        f"{st['spec_proposed']}")
    check(pool.dtype == "float32" and have == want_bytes,
          f"the KV pool holds {have} bytes, not {want_bytes} of f32 pages")
    check(all(n > 0 for n in got.values()),
          f"a kernel of run KV never ran on bf16 q over f32 pages: {got}")
    check(st["mixed_steps"] > 0 and st["spec_proposed"] > 0,
          f"run KV ran no mixed step or drafted nothing: {st}")
    del cb
    free_card(torch)
    rag = serve_run(torch, dev, model, cfg, serve["prompts"][1:6], [16] * 5,
                    card, "run KV, ragged decode (run 1's prompts 2-6)",
                    ("ragged_decode",), dict(RUN_KV, use_ragged=True))
    rag.pop("cb")
    n = rag["dtype_counts"].get(("ragged_decode", "bfloat16", "float32"), 0)
    check(n > 0, "ragged_decode never ran on bf16 q over f32 pages")
    log(f"serve run KV took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    res["dtype_counts"] = {k: res["dtype_counts"].get(k, 0)
                           + rag["dtype_counts"].get(k, 0)
                           for k in {*res["dtype_counts"],
                                     *rag["dtype_counts"]}}
    return res


def serve_f16_phase(torch, dev, seed, layers, card):
    """Serve run F16: Llama-2-7B widths in float16, ``layers`` layers,
    random weights from its own seed, the default (f16) KV pool, run 3's
    configuration (ragged decode, chunked prefill 256, 4 drafts, sampling
    on) and traffic (run 1's prompts and two lookup prompts, 7 of 10
    requests sampled). Gates: every request ok, drafts proposed and
    rejected (accepted ones on f16 pages: the 2-layer f16 gate's
    ``draft_check``); rms_norm, flash_fwd, ragged_decode and paged_varq
    launched on f16 operands, categorical_rows launched (its logits are
    f32, cast from the f16 model's as the reference casts them). Prints
    decode tokens/s, TTFT p50, peak memory and, from one profiled pass,
    the idle share. Returns the run's numbers and launch counts."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers, dtype="float16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed + 16))
    gen = torch.Generator().manual_seed(seed + 2)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    # run 1's prompts, drawn as serve_phase draws them
    shared = toks(8 * 16 + 5)
    prompts = [toks(512), toks(48), shared, toks(32), toks(300),
               shared + toks(91), toks(200), toks(130)]
    max_new = [64, 40, 48, 32, 56, 48, 36, 60, 64, 64]
    label = (f"run F16 ({layers} layers, float16 weights and pages; ragged "
             "decode, chunked prefill 256, 4 drafts, 3 greedy and 7 "
             "sampled)")
    reps = [lookup_prompt(torch, model, dev, toks, 64, 5, 16, **GEOM,
                          **dict(RUN2, spec_draft_tokens=0))
            for _ in range(2)]
    res = serve_run(torch, dev, model, cfg, prompts + reps, max_new, card,
                    label, RUN3_KERNELS, RUN3, run3_sampling())
    cb = res.pop("cb")
    st = res["stats"]
    log(f"serve run F16: drafts accepted {st['spec_accepted']} of "
        f"{st['spec_proposed']} (sampled lookup prompts)")
    check(st["spec_accepted"] < st["spec_proposed"],
          f"run F16 rejected no draft: {st}")
    f16 = dtype_launches(res["dtype_counts"], F16_KERNELS, "float16",
                         "float16")
    log(f"serve run F16: pool {cb.pool.dtype}; launches on float16 "
        f"operands {f16}; categorical_rows {res['counts']['categorical_rows']}"
        f" (f32 logits)")
    check(cb.pool.dtype == "float16", f"run F16's pool is {cb.pool.dtype}")
    check(all(n > 0 for n in f16.values()),
          f"a kernel of run F16 never ran on f16 operands: {f16}")
    check(res["counts"]["categorical_rows"] > 0,
          "run F16 drew no sampled token on the card")
    sp = run3_sampling()
    res.update(serve_profile(torch, dev, model,
                             [(prompts + reps)[r] for r in RUN3_PICK], card,
                             RUN3, [sp[r] for r in RUN3_PICK], cb=cb))
    log(f"serve run F16 on {card}: decode {res['tok_s']:.1f} tok/s outside "
        f"monolithic prefill, TTFT p50 {res['ttft_p50_ms']:.1f} ms, peak "
        f"{res['peak_gib']:.2f} GiB, idle share {res['idle']:.3f} "
        f"(profiled pass)")
    log(f"serve run F16 took {time.perf_counter() - t0:.1f} s")
    del cb, model
    free_card(torch)
    return res


# f16 2-layer prefill logits, card vs CPU: |logit| < 4, where an f16 ulp
# is at most 2^-9 (2e-3); the two paths round each of the 2 x 7
# projections, the residual sums and the LM head at other places, so
# they may differ by a few ulps: 1e-2 (five ulps at the top)
LOGIT_TOL16 = dict(atol=1e-2, rtol=1e-2)
# an f32 model over bf16 pages, card vs CPU: both round K/V to bf16, but
# where the two sides' f32 K/V (within f32 rounding of each other)
# straddle a bf16 rounding boundary the stored pages differ by one bf16
# ulp (2^-8 relative), and the logits by up to that share of the top
# one: 1e-3 + 4e-3 |top logit|
PAGES_BF16_TOL = dict(atol=1e-3, rtol=4e-3)


def split_margins(torch, cpu, prompts, got, want, tol, label):
    """Greedy tokens of the card (``got``) and the CPU (``want``), equal
    per request up to their first difference, where the CPU model's top
    two logits (a plain forward of the prompt and the common tokens) must
    lie within ``tol`` of the top one: a near tie that rounding decides.
    Prints each difference; returns the number of requests that differ."""
    n = 0
    for r, (a, b) in enumerate(zip(got, want)):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        n += 1
        with torch.no_grad():
            lg = cpu(torch.tensor([prompts[r] + b[:i]]))[0, -1].float()
        top = lg.topk(2).values
        margin = float(top[0] - top[1])
        lim = tol["atol"] + tol["rtol"] * float(top[0].abs())
        log(f"{label}: request {r} leaves the CPU's tokens at token {i} "
            f"(card {a[i]}, CPU {b[i]}); the CPU's top-two margin there "
            f"{margin:.3e}, the tolerance {lim:.3e}")
        check(margin <= lim, f"{label}: greedy tokens differ at request {r} "
              f"token {i} where the CPU's margin {margin:.3e} exceeds the "
              f"tolerance {lim:.3e}")
    return n


def kv_dtype_gates(torch, dev, seed):
    """Card against CPU at 2 layers and full width. (a) An f32 model over
    a bf16 KV pool, block-table decode with the shared prefix's suffix
    prefill, and ragged decode with chunked prefill and drafts (one
    rejected at least): greedy tokens equal up to each request's
    first difference, which passes only at a near tie within
    ``PAGES_BF16_TOL`` (``split_margins``, each printed), and equal stats
    where no token differs. (b) An f16 model with its default pool:
    prefill logits within ``LOGIT_TOL16``, and block-table greedy tokens
    as (a)'s within ``LOGIT_TOL16``. Returns the card's per-instance
    launch counts of both."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    from paddle_tpu_torch.kernels import (dtype_launch_counts,
                                          reset_launch_counts)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    counts = {}
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed + 20))
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(seed + 21)

    def toks(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    geom = dict(max_batch_size=2, page_size=16, max_seq_len=256,
                kv_dtype="bfloat16")

    def served(label, kw, prompts):
        """The prompts on the card (counted) and on the CPU."""
        reset_launch_counts()
        card = ContinuousBatchingPredictor(gpu, device=dev, **geom, **kw)
        got = card.generate(prompts, max_new_tokens=12)
        torch.cuda.synchronize()
        host = ContinuousBatchingPredictor(cpu, device="cpu", **geom, **kw)
        want = host.generate(prompts, max_new_tokens=12)
        log(f"f32 model, bfloat16 KV pool, 2 layers, {label}: greedy tokens "
            f"card == CPU: {got == want}; stats equal: "
            f"{card.stats == host.stats}; card stats {card.stats}")
        if not split_margins(torch, cpu, prompts, got, want, PAGES_BF16_TOL,
                             f"f32 / bf16 pool, {label}"):
            check(card.stats == host.stats, f"stats differ ({label})")
        return card.stats, dict(dtype_launch_counts)
    shared = toks(37)
    st, counts = served("block-table", dict(use_ragged=False),
                        [toks(40), shared, shared + toks(21)])
    check(st["prefix_partial_hits"] >= 1,
          f"the f32 / bf16-pool check took no suffix prefill: {st}")
    new = dict(use_ragged=True, prefill_chunk_tokens=64, spec_draft_tokens=4)
    # the lookup prompt is admitted third, after the chunked prompt's
    # mixed steps (which take no drafts), so its first decode tick drafts;
    # a rejected draft rolls its bf16 pages back (accepted drafts over
    # another dtype's pages: serve run KV)
    st, more = served("ragged + chunked (64) + speculative (4)", new,
                      [toks(100), toks(30), lookup_prompt(
                          torch, gpu, dev, toks, 16, 4, 8, use_ragged=False,
                          **geom)])
    check(st["spec_accepted"] < st["spec_proposed"]
          and st["chunked_requests"] >= 1,
          f"the f32 / bf16-pool check rejected no draft or chunked no "
          f"prompt: {st}")
    counts = {k: counts.get(k, 0) + more.get(k, 0) for k in {*counts, *more}}
    pb = dtype_launches(counts, ("paged_decode", "ragged_decode",
                                 "paged_varq"), "float32", "bfloat16")
    check(all(n > 0 for n in pb.values()),
          f"a decode kernel never ran on f32 q over bf16 pages: {pb}")
    log(f"f32 / bf16-pool gate: launches with (float32 q, bfloat16 pages) "
        f"{pb}")
    del gpu
    free_card(torch)

    # (b) f16: the same weights cast, the default pool
    cpu16 = cpu.to(torch.float16)
    gpu16 = LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_layers=2,
                                                   dtype="float16"),
                             device=dev)
    gpu16.load_state_dict(cpu16.state_dict())
    s = 32
    ids = torch.tensor([toks(s), [0] * 7 + toks(s - 7)])
    lens = torch.tensor([s, s - 7])
    pos = torch.zeros(2, s, dtype=torch.long)
    for i, L in enumerate(lens.tolist()):
        pos[i, s - L:] = torch.arange(L)
    mask, key_valid = prefill_mask(torch, "cpu", lens, s)
    with torch.no_grad():
        want = cpu16(ids, attn_mask=mask, position_ids=pos).float()
        got = gpu16(ids.to(dev), attn_mask=mask.to(dev),
                    position_ids=pos.to(dev)).float().cpu()
    check(bool(torch.isfinite(got).all()), "f16 prefill logits non-finite")
    err = float((got[key_valid] - want[key_valid]).abs().max())
    ok = torch.allclose(got[key_valid], want[key_valid], **LOGIT_TOL16)
    log(f"f16 2-layer full-width prefill logits, card vs CPU: max_abs_err="
        f"{err:.3e} (atol={LOGIT_TOL16['atol']}, rtol={LOGIT_TOL16['rtol']})"
        f", largest |logit| {float(want.abs().max()):.3f} "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok, "f16 prefill logits differ between the card and the CPU")
    shared = toks(21)
    prompts = [toks(24), shared, shared + toks(13)]
    geom16 = dict(max_batch_size=2, page_size=16, max_seq_len=128,
                  use_ragged=False)
    reset_launch_counts()
    card = ContinuousBatchingPredictor(gpu16, device=dev, **geom16)
    got = card.generate(prompts, max_new_tokens=8)
    torch.cuda.synchronize()
    for k, n in dtype_launch_counts.items():
        counts[k] = counts.get(k, 0) + n
    check(card.pool.dtype == "float16", "the f16 model's pool is not f16")
    want = ContinuousBatchingPredictor(cpu16, device="cpu", **geom16).generate(
        prompts, max_new_tokens=8)
    split_margins(torch, cpu16, prompts, got, want, LOGIT_TOL16, "f16 greedy")
    log(f"f16 2-layer greedy tokens (block-table decode, suffix prefill): "
        f"card == CPU for {sum(a == b for a, b in zip(got, want))} of "
        f"{len(got)} requests; stats {card.stats}")
    check(card.stats["prefix_partial_hits"] >= 1,
          "the f16 gate took no suffix prefill")
    # accepted and rejected drafts over f16 pages, on the card
    reset_launch_counts()
    draft_check(torch, dev, gpu16, toks, dict(
        max_batch_size=2, page_size=16, max_seq_len=256, use_ragged=True,
        prefill_chunk_tokens=64), "f16 2-layer drafts")
    for k, n in dtype_launch_counts.items():
        counts[k] = counts.get(k, 0) + n
    return counts


def bert_f16_eval(torch, dev, seed, card):
    """BERT-base in float16 (its f32 init cast), one eval forward of a
    16 x 128 batch with row lengths 32-128 through the model's
    ``attention_mask``: finite logits near the f32 model's (logged), and
    25 LayerNorm and 12 flash launches on f16 operands. Returns the
    per-instance launch counts."""
    from paddle_tpu_torch.kernels import (dtype_launch_counts,
                                          reset_launch_counts)
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)
    cfg = BertConfig(num_labels=2)
    model = BertForSequenceClassification(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed + 30)).eval()
    rng = torch.Generator(device=dev).manual_seed(seed + 31)
    ids = torch.randint(0, cfg.vocab_size, (16, 128), device=dev,
                        generator=rng)
    lens = torch.randint(32, 129, (16,), device=dev, generator=rng)
    mask = (torch.arange(128, device=dev)[None, :] < lens[:, None]).long()
    with torch.no_grad():
        want = model(ids, attention_mask=mask)
        model.half()
        reset_launch_counts()
        got = model(ids, attention_mask=mask)
        torch.cuda.synchronize()
    counts = dict(dtype_launch_counts)
    n = dtype_launches(counts, ("layer_norm", "flash_fwd"), "float16",
                       "float16")
    err = float((got.float() - want).abs().max())
    log(f"BERT-base float16 eval forward on {card}: logits max |f16 - f32| "
        f"{err:.3e} (largest |f32 logit| {float(want.abs().max()):.3e}); "
        f"launches on f16 operands {n}")
    check(bool(torch.isfinite(got).all()), "BERT f16 logits non-finite")
    check(n == {"layer_norm": 2 * cfg.num_hidden_layers + 1,
                "flash_fwd": cfg.num_hidden_layers},
          f"BERT f16 eval launches {n}")
    del model
    free_card(torch)
    return counts


# -------------------------------------------------------------- front end --

FRONT_TIERS = {"interactive": 4, "batch": 1}


def stream_run(torch, dev, model, prompts, max_new, card, label, kw=None,
               cb=None, required=()):
    """One counted stream of ``prompts`` through ``generate_stream`` (on
    ``cb``, else on a new predictor of ``kw``): launch counters set to 0
    just before it and read just after; every kernel in ``required``
    must have launched and every request must end 'ok'. Returns {"outs":
    each request's concatenated spans, "first_ms": ms from the call to
    each request's first event, "first_frac": the stream's first event
    over its wall time, "tok_s": decode tokens/s outside monolithic
    prefill, "peak_gib", "counts", "cb"}."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    if cb is None:
        cb = ContinuousBatchingPredictor(model, device=dev, **GEOM, **kw)
    prefill_s = time_prefills(cb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    st = cb.generate_stream(prompts, max_new_tokens=max_new)
    outs = [[] for _ in prompts]
    first = [None] * len(prompts)
    ends = {}
    for ev in st:
        t = time.perf_counter() - t0
        if first[ev.request] is None:
            first[ev.request] = t
        if ev.kind == "token":
            outs[ev.request].extend(ev.span)
        else:
            ends[ev.request] = ev.status
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    untime_prefills(cb)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(outs == st.results, f"{label}: the spans are not the results")
    check([ends.get(r) for r in range(len(prompts))] == ["ok"] * len(prompts)
          and st.status == ["ok"] * len(prompts),
          f"{label}: a request did not end ok: {st.status}")
    check(all(counts[k] > 0 for k in required),
          f"a kernel of {label} was never launched in it: {counts}")
    dec_tok = sum(len(o) for o in outs) - len(outs)
    dec_s = max(wall - prefill_s[0], 1e-9)
    first_ms = [t * 1e3 for t in first]
    log(f"front end {label} on {card}: first event p50 "
        f"{statistics.median(first_ms):.1f} ms (stream's first at "
        f"{min(first_ms):.1f} of {wall * 1e3:.1f} ms); decode {dec_tok} "
        f"tokens in {dec_s:.2f} s outside monolithic prefill "
        f"({dec_tok / dec_s:.1f} tok/s); peak memory {peak:.2f} GiB")
    return {"outs": outs, "first_ms": first_ms,
            "first_frac": min(first) / wall, "tok_s": dec_tok / dec_s,
            "peak_gib": peak, "counts": counts, "cb": cb}


def no_page_held(cb, label):
    """Every page is free or held by the prefix cache alone (the pool's
    free count includes the cache's idle pages)."""
    idle = cb.prefix_cache.reclaimable_count(cb.pool) \
        if cb.prefix_cache is not None else 0
    log(f"front end {label}: {len(cb.pool._free)} free pages + {idle} idle "
        f"in the prefix cache of {cb.capacity}")
    check(cb.pool.free_count == cb.capacity,
          f"{label}: a slot still holds pages")


def frontend_phase(torch, dev, seed, card, serve):
    """The serving front end on the serve phase's model and run 1's
    configuration: (a) run 1's requests through generate() and streamed,
    unarmed and with the watchdog armed at 30 s, (b) tiers and shedding,
    (c) deadlines and cancellation, (d) a wedged decode under a 0.5 s
    watchdog, (e) ``serve_stream``. Returns the streamed tokens (run
    1's) and (a)'s rates."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    from paddle_tpu_torch.serving import ServeRequest
    model, prompts, max_new = serve["model"], serve["prompts"], \
        serve["max_new"]
    run1 = serve["runs"][0]
    n = len(prompts)

    def fresh(**kw):
        return ContinuousBatchingPredictor(model, device=dev, **GEOM, **RUN1,
                                           **kw)

    # (a) run 1's requests through generate() and streamed, unarmed and
    # with the watchdog armed at 30 s ((d), first part), each on a fresh
    # predictor, in the order g s w s g so that the three compare within
    # this phase: every run gives run 1's tokens and launches each kernel
    # as often as run 1
    modes = ("generate", "stream", "armed", "stream", "generate")
    rates = {m: [] for m in modes}
    firsts = {m: [] for m in modes}
    peaks = {m: [] for m in modes}
    for mode in modes:
        if mode == "generate":
            r = serve_run(torch, dev, model, model.config, prompts, max_new,
                          card, "(a) run 1 through generate()",
                          RUN1_KERNELS, RUN1)
            firsts[mode].append(r["ttft_p50_ms"])
        else:
            r = stream_run(torch, dev, model, prompts, max_new, card,
                           f"(a) run 1 streamed, watchdog "
                           f"{'armed at 30 s' if mode == 'armed' else 'unarmed'}",
                           cb=fresh(decode_watchdog_s=30.0
                                    if mode == "armed" else None),
                           required=RUN1_KERNELS)
            firsts[mode].append(statistics.median(r["first_ms"]))
            check(r["first_frac"] < 0.5, f"the first event came at "
                  f"{r['first_frac']:.3f} of the stream's wall time")
        cb = r.pop("cb")
        diff = [i for i, (x, y) in enumerate(zip(r["outs"], run1["outs"]))
                if x != y]
        check(not diff, f"(a) {mode}: tokens differ from run 1's for {diff}")
        check(r["counts"] == run1["counts"],
              f"(a) {mode}: launches {r['counts']} vs run 1's "
              f"{run1['counts']}")
        check(cb.stats["watchdog_trips"] == 0, "the watchdog tripped")
        no_page_held(cb, f"(a) {mode}")
        rates[mode].append(r["tok_s"])
        peaks[mode].append(r["peak_gib"])
        del cb
        free_card(torch)
    mean = {m: statistics.mean(v) for m, v in rates.items()}
    log(f"front end (a) on {card}: run 1's tokens in every run; decode "
        f"tok/s generate() {rates['generate']}, streamed "
        f"{rates['stream']}, streamed with the watchdog armed at 30 s "
        f"{rates['armed']} (means {mean['generate']:.1f} / "
        f"{mean['stream']:.1f} / {mean['armed']:.1f}); TTFT p50 of "
        f"generate() {firsts['generate']} ms, first-event p50 streamed "
        f"{firsts['stream']} and armed {firsts['armed']} ms; peak memory "
        f"{peaks['generate']} / {peaks['stream']} / {peaks['armed']} GiB")
    # (b) tiers and shedding: 4 interactive and 12 batch requests into a
    # queue bounded at 8; the batch tier is over its weight share (8/5)
    # and sheds its 8 newest, the interactive one within its share (32/5)
    gen = torch.Generator().manual_seed(seed + 5)
    lens = torch.randint(32, 301, (16,), generator=gen).tolist()
    budgets = torch.randint(16, 33, (16,), generator=gen).tolist()
    tiers = ["interactive" if r % 4 == 0 else "batch" for r in range(16)]
    ps = [torch.randint(1, model.config.vocab_size, (L,),
                        generator=gen).tolist() for L in lens]
    cb = fresh(max_queue=8, shed_policy="newest")
    t0 = time.perf_counter()
    outs = cb.generate(ps, max_new_tokens=budgets, tiers=tiers,
                       tier_weights=FRONT_TIERS)
    st = cb.last_status
    shed = [r for r in range(16) if st[r] == "shed"]
    log(f"front end (b) on {card}: 16 requests ({tiers.count('interactive')}"
        f" interactive), max_queue 8, newest: shed {shed} in "
        f"{time.perf_counter() - t0:.2f} s; status {st}; stats {cb.stats}")
    check(len(shed) == 8 and all(tiers[r] == "batch" for r in shed)
          and cb.stats["shed_requests"] == 8,
          f"not exactly 8 batch requests shed: {shed}")
    check(all(st[r] == "ok" and len(outs[r]) == budgets[r]
              for r in range(16) if r not in shed),
          "a request that was not shed did not end ok")
    no_page_held(cb, "(b)")

    # (c) deadlines and cancellation
    cb = fresh()
    outs = cb.generate([prompts[1], prompts[3]], max_new_tokens=[8, 8],
                       deadline_s=[0.0, None])
    log(f"front end (c) on {card}: deadline_s 0 and none: status "
        f"{cb.last_status}, tokens {[len(o) for o in outs]}")
    check(cb.last_status == ["deadline", "ok"] and outs[0] == []
          and len(outs[1]) == 8, "deadline_s=0 did not end 'deadline'")
    no_page_held(cb, "(c) deadline")
    victim = 1
    cb = fresh()
    st = cb.generate_stream(prompts, max_new_tokens=max_new)
    cut = None
    for ev in st:
        if cut is None and ev.request == victim and ev.kind == "token" \
                and ev.index >= 4:
            st.cancel(victim)
            cut = ev.index
    got = st.results[victim]
    log(f"front end (c) on {card}: request {victim} cancelled at its "
        f"token {cut}: status {st.status[victim]}, {len(got)} of "
        f"{max_new[victim]} tokens, a prefix of run 1's: "
        f"{got == run1['outs'][victim][:len(got)]}; the others "
        f"{[s for r, s in enumerate(st.status) if r != victim]}; "
        f"cancelled_requests {cb.stats['cancelled_requests']}")
    check(st.status[victim] == "cancelled"
          and 4 <= len(got) < max_new[victim]
          and got == run1["outs"][victim][:len(got)],
          "the cancelled request did not end with a prefix of its tokens")
    check(all(s == "ok" for r, s in enumerate(st.status) if r != victim),
          "a request that was not cancelled did not end ok")
    no_page_held(cb, "(c) cancel")
    cb = fresh()
    with cb.generate_stream(prompts, max_new_tokens=max_new) as st:
        for k, ev in enumerate(st, 1):
            if k == 3:
                break
    log(f"front end (c) on {card}: stream closed after 3 events: status "
        f"{st.status}; cancelled_requests {cb.stats['cancelled_requests']}")
    check(st.status == ["cancelled"] * n
          and cb.stats["cancelled_requests"] == n,
          "closing the stream did not cancel every pending request")
    no_page_held(cb, "(c) close")
    del cb
    free_card(torch)

    # (d) a wedged decode: the first resolve's "ready" is held false for
    # 5 s; the 0.5 s watchdog fails every request instead of hanging
    # the trip dumps the flight recorder, which must name the wedged
    # requests' serve.request spans
    flight = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output", "chip_smoke_flight")
    shutil.rmtree(flight, ignore_errors=True)
    obs.set_flight_dir(flight)
    telemetry_reset()
    flags.set_flags({"fault_injection": "decode_wedge:sleep=5"})
    try:
        cb = fresh(decode_watchdog_s=0.5)
        t0 = time.perf_counter()
        cb.generate(prompts, max_new_tokens=max_new)
        took = time.perf_counter() - t0
    finally:
        flags.set_flags({"fault_injection": ""})
        obs.set_flight_dir(None)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    log(f"front end (d) on {card}: decode_wedge:sleep=5 under a 0.5 s "
        f"watchdog: returned in {took:.2f} s, trips "
        f"{cb.stats['watchdog_trips']}, status {cb.last_status}; the "
        f"device synchronized {time.perf_counter() - t0:.3f} s after")
    check(took < 5 and cb.stats["watchdog_trips"] == 1
          and cb.last_status == ["watchdog"] * n,
          "the watchdog did not fail the wedged call")
    dump = obs.flight_recorder().last_dump
    with open(dump) as f:
        fd = json.load(f)
    wedged = sorted(s["labels"]["idx"] for s in fd["spans"]
                    if s["name"] == "serve.request"
                    and s["status"] == "watchdog"
                    and s["events"][-1]["name"] == "watchdog")
    log(f"front end (d): flight dump {os.path.relpath(dump)} (reason "
        f"{fd['reason']}): {len(fd['spans'])} spans, the wedged requests' "
        f"serve.request spans {wedged}, fault events "
        f"{[e['site'] for e in fd.get('fault_events', [])]}")
    check(fd["reason"] == "decode_wedged" and wedged == list(range(n)),
          f"the flight dump does not name every wedged request: {wedged}")
    shutil.rmtree(flight, ignore_errors=True)
    del cb
    free_card(torch)

    # (e) serve_stream: 2 requests a poll for 4 polls, then None
    budgets = [min(m, 16) for m in max_new]
    reqs = [ServeRequest(p, m, meta=r)
            for r, (p, m) in enumerate(zip(prompts, budgets))]
    polls = iter(range(4))

    def intake():
        i = next(polls, None)
        return None if i is None else reqs[2 * i:2 * i + 2]
    cb = fresh()
    t0 = time.perf_counter()
    st = cb.serve_stream(intake)
    metas = {}
    for ev in st:
        metas.setdefault(ev.request, ev.meta)
    log(f"front end (e) on {card}: serve_stream over 4 polls: status "
        f"{st.status}, tokens {[len(o) for o in st.results]} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(st.status == ["ok"] * n
          and [len(o) for o in st.results] == budgets
          and metas == {r: r for r in range(n)},
          "serve_stream did not serve every request of its intake")
    no_page_held(cb, "(e)")
    del cb
    free_card(torch)
    return {"stream_outs": run1["outs"], "rates": rates, "firsts": firsts}


# ---------------------------------------------------------- inference API --

# LLMPredictor's prompts: two micro-batches of max_batch_size 8, one padded
# to the 512 bucket and one to the 128 bucket
INFER_LENS = ((300, 17, 256, 40, 128, 200, 64, 90), (33, 120, 77, 25))
INFER_NEW = 32
INFER_DIR = os.path.join("output", "chip_smoke_infer")
INFER_CHILD_TIMEOUT = 300
INFER_RUNS = 10


def flash_decode_row(torch, dev, g, dtype="bfloat16"):
    """The forward at the static route's decode shape: one query row per
    sequence, q[8, 1, 32, 128] (bf16, or ``dtype``) against the whole
    cache k, v[8, 544, 32, 128] (a 512-token bucket and 32 new tokens)
    under a bool padding mask (each row's prompt and its first 8 decode
    slots valid), against its plain version, a second launch bitwise the
    first, timed beside SDPA with the same mask and the bytes bound."""
    from paddle_tpu_torch.kernels import attention as A
    F = torch.nn.functional
    b, h, d, s = 8, 32, 128, 512
    ml = s + INFER_NEW
    lens = torch.tensor(INFER_LENS[0], device=dev)
    j = torch.arange(ml, device=dev)[None, :]
    keep = ((j >= s - lens[:, None]) & (j < s + 8))[:, None, None, :]
    madd = A.additive_mask(keep, b, h, 1, ml)
    dt = getattr(torch, dtype)
    sets = [tuple(torch.randn(b, n, h, d, device=dev, generator=g).to(dt)
                  for n in (1, ml, ml)) for _ in range(2)]
    sc = d ** -0.5
    shape = (f"q[{b}, 1, {h}, {d}] k, v[{b}, {ml}, {h}, {d}] {dtype}, bool "
             "padding mask")
    out, lse = A.flash_attention_kernel(*sets[0], sc, False, madd)
    err = compare(torch, f"flash_fwd static decode {shape}", out,
                  A.flash_attention_plain(*sets[0], sc, False, madd),
                  dtype)
    check(torch.equal(out, A.flash_attention_kernel(*sets[0], sc, False,
                                                    madd)[0]),
          f"flash_fwd static decode {dtype}: a second launch differs")
    t = time_ms(torch, lambda q, k, v: A.flash_attention_kernel(
        q, k, v, sc, False, madd), sets)
    lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=keep, scale=sc), sets)["median"]
    pairs = int(keep.sum()) * h
    isz = out.element_size()
    # K and V only at the key slots the mask keeps: a masked key adds
    # nothing to the output, so the function need not read it
    nbytes = (2 * out.numel() + 2 * d * pairs) * isz \
        + madd.numel() * 4 + lse.numel() * 4
    b_ms, by = bound(nbytes, 4 * d * pairs, dtype)
    log(f"  flash_fwd at the static decode shape, {shape}: kernel median "
        f"{t['median']:.4f} ms (CUPTI {t['cupti']:.4f}), bound {b_ms:.4f} "
        f"ms ({by}), SDPA (same mask) {lib:.4f} ms")
    return {"decode_shape": shape, "decode_ms": t["median"],
            "decode_cupti_ms": t["cupti"], "decode_bound_ms": b_ms,
            "decode_library_ms": lib, "decode_max_abs_err": err}


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same(a, b):
    """Equal bit for bit: generate()'s (tokens, scores) or token lists."""
    if isinstance(a, tuple):
        return all(x.shape == y.shape and bool((x == y).all())
                   for x, y in zip(a, b))
    return a == b


GRAPH_KERNELS = ("rms_norm", "layer_norm", "flash_fwd", "categorical_rows")


class eager_static_route:
    """``generate()``'s static route run eagerly, without its CUDA
    graphs: the step loop of a signature is built and run at every call
    (only the dispatch is replaced; ``_run_program`` keeps its eval and
    ``no_grad``). For timing the eager loop beside the replays; outside
    the ``with`` every signature replays as before."""

    def __enter__(self):
        from paddle_tpu_torch.generation import GenerationMixin
        self._real = GenerationMixin._dispatch
        GenerationMixin._dispatch = \
            lambda self, cache, sig, build, args: build()(*args)
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.generation import GenerationMixin
        GenerationMixin._dispatch = self._real


def graph_run(torch, fn, label, want=None, reps=3):
    """``fn()`` on static-route signatures this process has not seen: the
    first call runs the loop eagerly and captures each signature's CUDA
    graph; ``reps`` replays each equal it bit for bit and launch what it
    launched; then ``reps`` eager runs of the same loop without graphs
    (``eager_static_route``) equal it too. With ``want``, the first
    call's launches must equal it. Returns (output, median eager s,
    median replay s, capture s, the first call's launches)."""
    from paddle_tpu_torch.generation import graph_stats
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    cap0, n0 = graph_stats["capture_s"], graph_stats["captures"]
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    cap = graph_stats["capture_s"] - cap0
    check(graph_stats["captures"] > n0,
          f"{label}: the first call captured no graph")
    got = {k: counts.get(k, 0) for k in (want or GRAPH_KERNELS)}
    if want is not None:
        check(got == want, f"{label}: launches {got}, the route predicts "
              f"{want}")
    n1, r0 = graph_stats["captures"], graph_stats["replays"]
    times = {"replay": [], "eager": []}
    for mode in ("replay", "eager"):
        for _ in range(reps):
            reset_launch_counts()
            if mode == "replay":
                again, t = _sync_time(torch, fn)
            else:
                with eager_static_route():
                    again, t = _sync_time(torch, fn)
            times[mode].append(t)
            check(_same(again, out), f"{label}: a {mode} run differs from "
                  "the first call")
            check({k: launch_counts[k] for k in got} == got,
                  f"{label}: a {mode} run launched {dict(launch_counts)}, "
                  f"the first call {got}")
    # each call runs the n1 - n0 signatures the first call captured
    check(graph_stats["replays"] == r0 + reps * (n1 - n0)
          and graph_stats["captures"] == n1,
          f"{label}: the later calls did not replay ({graph_stats})")
    return (out, statistics.median(times["eager"]),
            statistics.median(times["replay"]), cap, counts)


def left_padded(torch, vocab, lens, gen):
    """[B, max(lens)] ids and mask of prompts of ``lens`` tokens, padding
    on the left."""
    import numpy as np
    s = max(lens)
    ids = np.zeros((len(lens), s), np.int64)
    mask = np.zeros((len(lens), s), np.int32)
    for r, n in enumerate(lens):
        ids[r, s - n:] = torch.randint(1, vocab, (n,), generator=gen).numpy()
        mask[r, s - n:] = 1
    return ids, mask


def llm_phase(torch, dev, seed, card, model):
    """(a) LLMPredictor on the serve model through the static route,
    greedy and sampled, and beam search on 4 of its prompts: each
    signature's eager first call (captured into a CUDA graph) and its
    replays, bit for bit equal, with the launches the route predicts;
    (b) SpeculativePredictor with a 2-layer draft and with the target as
    its own draft. Returns the launch counts of the greedy run."""
    from paddle_tpu_torch.generation import graph_stats
    from paddle_tpu_torch.inference import LLMPredictor, SpeculativePredictor
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = model.config
    layers = cfg.num_hidden_layers
    gen = torch.Generator().manual_seed(seed + 12)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for lens in INFER_LENS for n in lens]
    pred = LLMPredictor(model, max_batch_size=8)
    calls = len(INFER_LENS)
    # every generate() call runs INFER_NEW forwards (the prefill and
    # INFER_NEW - 1 cached steps): 2L + 1 RMSNorms and L flash forwards
    # each; a sampled call draws once a step, a greedy one never
    want = {"rms_norm": calls * INFER_NEW * (2 * layers + 1),
            "flash_fwd": calls * INFER_NEW * layers, "categorical_rows": 0}
    _, pre_e, pre_r, cap_pre, _ = graph_run(
        torch, lambda: pred.generate(prompts, 1), "LLMPredictor prefill")
    torch.cuda.reset_peak_memory_stats()
    outs, full_e, full_r, cap, counts = graph_run(
        torch, lambda: pred.generate(prompts, INFER_NEW),
        "LLMPredictor greedy", want)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(outs) == len(prompts)
          and all(len(o) == INFER_NEW for o in outs),
          f"LLMPredictor: rows without their {INFER_NEW} tokens: "
          f"{[len(o) for o in outs]}")
    rows = len(prompts) * (INFER_NEW - 1)
    tok_e, tok_s = rows / (full_e - pre_e), rows / (full_r - pre_r)
    log(f"infer (a) LLMPredictor on {card}: {len(prompts)} prompts of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens in "
        f"{calls} micro-batches of 8 (buckets 512, 128), {INFER_NEW} new "
        f"greedy: decode eager {tok_e:.1f} | replayed graphs "
        f"{tok_s:.1f} tok/s; prefill {pre_e * 1e3:.1f} | {pre_r * 1e3:.1f} "
        f"ms, whole call {full_e * 1e3:.1f} | {full_r * 1e3:.1f} ms; "
        f"capture {cap_pre + cap:.2f} s (2 + 2 signatures); peak "
        f"{peak:.2f} GiB; replays and eager runs equal the first call bit for bit; "
        f"launches {want} == predicted")
    static_profile(torch, pred, prompts[:8], card)
    sampled = dict(decode_strategy="sampling", temperature=0.8, top_p=0.9,
                   seed=seed + 5)
    want_s = dict(want, categorical_rows=calls * INFER_NEW)
    souts, s_e, s_r, _, _ = graph_run(
        torch, lambda: pred.generate(prompts, INFER_NEW, **sampled),
        "sampled LLMPredictor", want_s)
    check(all(len(o) == INFER_NEW for o in souts),
          f"sampled LLMPredictor: lengths {[len(o) for o in souts]}")
    n_tok = len(prompts) * INFER_NEW
    log(f"infer (a) sampled (temperature 0.8, top-p 0.9, seed {seed + 5}): "
        f"eager {n_tok / s_e:.1f} | replayed {n_tok / s_r:.1f} tok/s whole "
        f"call; the seed replays its tokens; "
        f"{sum(a != b for a, b in zip(outs, souts))} of {len(outs)} rows "
        f"differ from greedy; launches {want_s}")
    # beam search on the 32-layer model: 4 prompts of 17-300 tokens
    import numpy as np
    ids = np.zeros((4, max(INFER_LENS[0][:4])), np.int64)
    mask = np.zeros_like(ids, dtype=np.int32)
    for r, p in enumerate(prompts[:4]):
        ids[r, ids.shape[1] - len(p):] = p
        mask[r, ids.shape[1] - len(p):] = 1
    beam = dict(decode_strategy="beam_search", num_beams=4,
                length_penalty=0.6)
    want_b = {"rms_norm": INFER_NEW * (2 * layers + 1),
              "flash_fwd": INFER_NEW * layers, "categorical_rows": 0}
    _, bp_e, bp_r, bcap_p, _ = graph_run(
        torch, lambda: model.generate(ids, attention_mask=mask,
                                      max_new_tokens=1, **beam),
        "beam search prefill")
    torch.cuda.reset_peak_memory_stats()
    (btok, bsc), b_e, b_r, bcap, _ = graph_run(
        torch, lambda: model.generate(ids, attention_mask=mask,
                                      max_new_tokens=INFER_NEW, **beam),
        "beam search", want_b)
    bpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(tuple(btok.shape) == (4, INFER_NEW)
          and bool(torch.isfinite(bsc).all()),
          f"beam search: tokens {tuple(btok.shape)}, scores {bsc.tolist()}")
    b_rows = 4 * (INFER_NEW - 1)
    log(f"infer (a) beam search (4 beams, length penalty 0.6) on {card}: 4 "
        f"prompts of {sorted(INFER_LENS[0][:4])} tokens, {INFER_NEW} new: "
        f"decode eager {b_rows / (b_e - bp_e):.1f} | replayed "
        f"{b_rows / (b_r - bp_r):.1f} tok/s (output tokens; 16 beam rows), "
        f"whole call {b_e * 1e3:.1f} | {b_r * 1e3:.1f} ms; capture "
        f"{bcap_p + bcap:.2f} s; peak {bpeak:.2f} GiB; scores "
        f"{[round(float(x), 3) for x in bsc]}; launches {want_b}")
    model._gen_cache.clear()
    draft = LlamaForCausalLM(
        LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="bfloat16"),
        device=dev).init_weights(torch.Generator(device=dev).manual_seed(
            seed + 13))
    prompt = prompts[3]
    for label, d in (("a 2-layer draft", draft), ("draft = target", model)):
        spec = SpeculativePredictor(model, d, gamma=4)
        toks, dt = _sync_time(torch, lambda: spec.generate(prompt,
                                                           INFER_NEW))
        st = spec.stats
        check(len(toks) == INFER_NEW, f"speculative: {len(toks)} tokens")
        log(f"infer (b) SpeculativePredictor, gamma 4, {label}: "
            f"target_calls {st['target_calls']}, accepted {st['accepted']} "
            f"/ proposed {st['proposed']}, {INFER_NEW / dt:.1f} tok/s (one "
            f"sequence; (a)'s batched greedy {tok_s:.1f}); tokens == (a)'s "
            f"greedy row: {toks == outs[3]} (bf16: near-ties may flip "
            "between forwards of other shapes)")
    del draft, pred
    log(f"infer (a) graphs so far: {graph_stats}")
    return {"counts": counts, "tok_s": tok_s, "tok_s_eager": tok_e}


PROFILE_NEW = 8        # steps of the traced call: the trace's size


def static_profile(torch, pred, prompts, card):
    """One traced LLMPredictor call (one micro-batch of 8, the 512
    bucket, PROFILE_NEW greedy tokens: the prefill and PROFILE_NEW - 1
    cached steps): device busy and idle share, host ops per forward and
    the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pred.generate(prompts, PROFILE_NEW)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_time(torch, lambda: pred.generate(prompts,
                                                          PROFILE_NEW))
    kern = device_kernel_ms(torch, prof)
    busy = sum(ms for ms, _ in kern.values())
    calls = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CPU)
    log(f"infer (a) static route profile on {card}: {len(prompts)} rows, "
        f"{PROFILE_NEW} forwards, wall {wall * 1e3:.1f} ms (traced), device "
        f"busy {busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}, host "
        f"ops {calls / PROFILE_NEW:.0f} per forward; top device time:")
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<6d} {name[:90]}")


def _timed_runs(torch, fn, runs=INFER_RUNS):
    """fn() once to warm up, then the median wall ms of ``runs`` calls,
    each ending in a device synchronize."""
    fn()
    ts = []
    for _ in range(runs):
        ts.append(_sync_time(torch, fn)[1] * 1e3)
    return statistics.median(ts)


def predictor_phase(torch, dev, seed, card):
    """(c) jit.save of ERNIE-3.0-base (f32 and bf16 at 16 x 128, and f32
    with a None batch dim) and of a 2-layer full-width bf16 Llama at 256
    tokens; a second process (``--infer-child``) that never imports the
    models runs each artifact through Config / create_predictor, one CUDA
    graph per input signature (the None batch dim at batch 16 and 5: two
    signatures): the first call's outputs within TOL of the live model's,
    every replay bitwise the first call, the launches of each kernel of
    the first call and of every replay equal to the live forward's, and
    one capture per signature."""
    import numpy as np
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification,
                                         LlamaConfig, LlamaForCausalLM)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        INFER_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    gen = torch.Generator().manual_seed(seed + 14)
    items = []

    def export(name, model, x, shape, dtype, kernels):
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        jit.save(model, path, input_spec=[jit.InputSpec(shape, "int64")])
        save_s = time.perf_counter() - t0
        check(os.path.exists(path + ".pt2"), f"{name}: export failed")
        with torch.no_grad():
            reset_launch_counts()
            want = model(x.to(dev)).float().cpu()
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts.items() if v}
            ms = _timed_runs(torch, lambda: model(x.to(dev)).float().cpu())
        check(all(counts.get(k, 0) > 0 for k in kernels),
              f"{name}: the live forward launched {counts}")
        np.save(path + ".x.npy", x.numpy())
        np.save(path + ".want.npy", want.numpy())
        items.append({"name": name, "path": path, "dtype": dtype,
                      "kernels": kernels, "counts": counts, "live_ms": ms,
                      "save_s": save_s, "dynamic": shape[0] is None})

    ernie = ErnieForSequenceClassification(ErnieConfig(), device=dev)
    ernie.init_weights(torch.Generator(device=dev).manual_seed(seed)).eval()
    ids = torch.randint(1, ErnieConfig().vocab_size, (16, 128), generator=gen)
    ek = ["layer_norm", "flash_fwd"]
    export("ernie_f32", ernie, ids, [16, 128], "float32", ek)
    export("ernie_dyn", ernie, ids, [None, 128], "float32", ek)
    ernie.to(torch.bfloat16)
    export("ernie_bf16", ernie, ids, [16, 128], "bfloat16", ek)
    del ernie
    free_card(torch)
    llama = LlamaForCausalLM(
        LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="bfloat16"),
        device=dev).init_weights(torch.Generator(device=dev).manual_seed(
            seed + 16))
    ids = torch.randint(1, llama.config.vocab_size, (1, 256), generator=gen)
    export("llama_2l", llama.eval(), ids, [1, 256], "bfloat16",
           ["rms_norm", "flash_fwd"])
    del llama
    free_card(torch)

    spec = {"items": items, "result": os.path.join(root, "child.json")}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--infer-child",
         os.path.join(root, "spec.json")], timeout=INFER_CHILD_TIMEOUT)
    check(proc.returncode == 0,
          f"the Predictor process failed (exit {proc.returncode})")
    with open(spec["result"]) as f:
        res = json.load(f)
    log(f"infer (c) the Predictor process took "
        f"{time.perf_counter() - t0:.1f} s; model modules it imported: "
        f"{res['models_imported'] or 'none'}")
    check(not res["models_imported"], "the Predictor process imported "
          f"{res['models_imported']}")
    for it in items:
        r = res[it["name"]]
        tol = TOL[it["dtype"]]
        sfxs = ("", "5") if it["dynamic"] else ("",)
        gs = r["graph_stats"]
        for sfx in sfxs:
            batch = 5 if sfx else 16 if it["name"].startswith("ernie") else 1
            log(f"infer (c) {it['name']} batch {batch} on {card}: first "
                f"call vs live max_abs_err {r['err' + sfx]:.3e} (atol="
                f"{tol['atol']}, rtol={tol['rtol']}) "
                f"{'ok' if r['ok' + sfx] else 'MISMATCH'}; "
                f"{PREDICTOR_REPLAYS} replays bitwise the first call: "
                f"{r['bitwise' + sfx]}; launches first call "
                f"{r['counts' + sfx]}, each replay "
                f"{r['replay_counts' + sfx]}, live {it['counts']}; ms a run "
                f"eager {r['ms_eager' + sfx]:.3f} | replayed "
                f"{r['ms' + sfx]:.3f} (live model {it['live_ms']:.3f})")
            check(r["ok" + sfx], f"{it['name']} batch {batch}: the loaded "
                  "program disagrees with the live model")
            check(r["bitwise" + sfx], f"{it['name']} batch {batch}: a "
                  "replay differs from the first call")
            check(r["counts" + sfx] == it["counts"]
                  and all(c == it["counts"]
                          for c in r["replay_counts" + sfx]),
                  f"{it['name']} batch {batch}: launches first "
                  f"{r['counts' + sfx]}, replays "
                  f"{r['replay_counts' + sfx]} vs live {it['counts']}")
        log(f"infer (c) {it['name']}: graphs {gs} (capture "
            f"{gs['capture_s']:.2f} s); jit.save {it['save_s']:.1f} s, load "
            f"{r['load_s']:.1f} s")
        check(gs["captures"] == len(sfxs) and gs["recaptures"] == 0,
              f"{it['name']}: not one capture per signature: {gs}")
    shutil.rmtree(root, ignore_errors=True)


PREDICTOR_REPLAYS = 3


def infer_child(torch, dev, spec_path):
    """The Predictor process of (c): imports the inference API only and
    runs each artifact per input signature: the first call (eager, then
    captured into the signature's CUDA graph), then ``PREDICTOR_REPLAYS``
    replays; writes the first call's agreement with the live model, its
    launches and each replay's, whether every replay equals the first
    call bit for bit, the graph counts, and ms a run eager (the loaded
    program called without graphs) and replayed."""
    import numpy as np
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    with open(spec_path) as f:
        spec = json.load(f)
    res = {}

    def counted(fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in launch_counts.items() if v}
    for it in spec["items"]:
        t0 = time.perf_counter()
        pred = create_predictor(Config(it["path"] + ".pdmodel"))
        load_s = time.perf_counter() - t0
        x = np.load(it["path"] + ".x.npy")
        want = np.load(it["path"] + ".want.npy")
        r = {"load_s": load_s}
        sigs = [("", len(x))] + ([("5", 5)] if it["dynamic"] else [])
        for sfx, n in sigs:
            xb, wb = x[:n], want[:n]
            first, counts = counted(lambda: pred.run([xb])[0])
            reps = [counted(lambda: pred.run([xb])[0])
                    for _ in range(PREDICTOR_REPLAYS)]

            def eager():
                with torch.no_grad():
                    return pred._layer(pred._to_device(xb)).float().cpu()
            r.update({
                "counts" + sfx: counts,
                "replay_counts" + sfx: [c for _, c in reps],
                "bitwise" + sfx: all(np.array_equal(o, first)
                                     for o, _ in reps),
                "err" + sfx: float(np.abs(first - wb).max()),
                "ok" + sfx: bool(np.allclose(first, wb, **TOL[it["dtype"]])),
                "ms_eager" + sfx: _timed_runs(torch, eager),
                "ms" + sfx: _timed_runs(torch, lambda: pred.run([xb]))})
        r["graph_stats"] = dict(pred.graph_stats)
        res[it["name"]] = r
        del pred
        free_card(torch)
    res["models_imported"] = sorted(
        m for m in sys.modules if m.startswith("paddle_tpu_torch.models"))
    with open(spec["result"], "w") as f:
        json.dump(res, f)
    return 0


def infer_f32_gates(torch, dev, seed):
    """(d) 2 layers at full width in f32 against the port on the CPU: the
    static route greedy and sampled and beam search on the static and the
    eager route over a left-padded batch, token for token (the card's
    static route through CUDA graphs); LLMPredictor with weight_only_int8
    and weight_only_int4 (quantized in place: int4 replays int8's graph);
    SpeculativePredictor against plain greedy."""
    import numpy as np
    from paddle_tpu_torch.generation import graph_stats
    from paddle_tpu_torch.inference import LLMPredictor, SpeculativePredictor
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    gpu = LlamaForCausalLM(cfg, device=dev)
    state = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu.load_state_dict(state)
    gen = torch.Generator().manual_seed(seed + 15)
    ids = torch.randint(1, cfg.vocab_size, (3, 40), generator=gen).numpy()
    mask = np.ones_like(ids)
    mask[1, :17] = 0            # left padding
    mask[2, 31:] = 0            # right padding, left-padded by generate
    greedy = cpu.generate(ids, attention_mask=mask, max_new_tokens=8)[0]
    f32_token_gate(torch, "Llama-2-7B widths", cpu, gpu, ids, mask, seed,
                   eos=int(greedy[0, 2]))
    prompts = [ids[0].tolist(), ids[1, 17:].tolist(), ids[2, :31].tolist()]
    before = dict(graph_stats)
    for quant in ("weight_only_int8", "weight_only_int4"):
        cpu.load_state_dict(state)
        gpu.load_state_dict(state)
        a = LLMPredictor(cpu, max_batch_size=3, quant_type=quant)
        b = LLMPredictor(gpu, max_batch_size=3, quant_type=quant)
        wdiff = max(float((p.detach().cpu() - q.detach()).abs().max())
                    for p, q in zip(gpu.parameters(), cpu.parameters()))
        want, got = a.generate(prompts, 8), b.generate(prompts, 8)
        log(f"infer (d) f32 LLMPredictor {quant}: card == CPU {got == want}; "
            f"quantized weights card vs CPU max_abs_diff {wdiff:.3e}")
        check(got == want, f"{quant}: card {got} vs CPU {want}")
    check(graph_stats["captures"] == before["captures"] + 1
          and graph_stats["replays"] == before["replays"] + 1,
          f"LLMPredictor int8 then int4: graphs {before} -> {graph_stats}; "
          "the in-place quantization should replay one capture")
    cpu.load_state_dict(state)
    gpu.load_state_dict(state)
    plain = LLMPredictor(gpu).generate([prompts[0]], 12)[0]
    check(plain == LLMPredictor(cpu).generate([prompts[0]], 12)[0],
          "f32 greedy LLMPredictor: card and CPU differ")
    draft = LlamaForCausalLM(
        LlamaConfig.llama2_7b(num_hidden_layers=1, dtype="float32"),
        device=dev).init_weights(torch.Generator(device=dev).manual_seed(
            seed + 17))
    for label, d in (("a 1-layer draft", draft), ("draft = target", gpu)):
        spec = SpeculativePredictor(gpu, d, gamma=4)
        toks = spec.generate(prompts[0], 12)
        log(f"infer (d) f32 SpeculativePredictor, {label}: == plain greedy "
            f"{toks == plain}; stats {spec.stats}")
        check(toks == plain, f"speculative ({label}) {toks} vs plain "
              f"greedy {plain}")
    del cpu, gpu, draft


def infer_phase(torch, dev, seed, card, model):
    """The inference-API phase on the serve model, (a) to (d); (e) runs
    with the kernels (``flash_decode_row``). Returns (a)'s launches."""
    t0 = time.perf_counter()
    res = llm_phase(torch, dev, seed, card, model)
    log(f"infer (a)-(b) took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    predictor_phase(torch, dev, seed, card)
    log(f"infer (c) took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    infer_f32_gates(torch, dev, seed)
    free_card(torch)
    t1 = time.perf_counter()
    gpt_f32_gate(torch, dev, seed)
    log(f"infer (d) GPT gate took {time.perf_counter() - t1:.1f} s")
    log(f"infer (d) took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    return res


# ------------------------------------------------------ GPT (GPT-2 XL) --

GPT_LENS = (300, 17, 256, 40)     # 4 left-padded prompts of 17-300 tokens
GPT_NEW = 32
GPT_BEAMS = 4


def gpt_kernel_rows(torch, dev, g):
    """The shapes GPT-2 XL gives two kernels that no other row times:
    LayerNorm at x[1200, 1600] bf16 (the prefill of the 4 x 300 tokens;
    D = 1600 is one block of 2048), and the flash forward at the beam
    route's static decode shape, q[16, 1, 25, 64] (4 sequences x 4
    beams, 25 heads of 64) against k, v[16, 332, 25, 64] bf16 under a
    bool padding mask (each row's prompt and its first 8 decode slots
    valid). Each against its plain version, a second launch bitwise the
    first, timed beside its bound, its plain version and ``F.layer_norm``
    / SDPA with the same mask. Returns {name: row}."""
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.kernels import norm
    F = torch.nn.functional
    rows = {}
    n, d = len(GPT_LENS) * max(GPT_LENS), 1600
    x = (3 * torch.randn(n, d, device=dev, generator=g) + 1).bfloat16()
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
    b = (0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
    # 16 sets of 3.8 MB: 61 MB of x rotate past the 50 MB L2
    sets = [(x, w, b)] + [(torch.randn_like(x), w, b) for _ in range(15)]
    shape = f"x[{n}, {d}] bfloat16"
    rows["layer_norm"] = dtype_row(
        torch, f"layer_norm GPT-2 XL {shape}",
        lambda a, c, e: norm.layer_norm_kernel(a, c, e, 1e-5),
        lambda a, c, e: norm.layer_norm_plain(a, c, e, 1e-5), sets,
        TOL["bfloat16"], 2 * x.numel() * 2 + 2 * d * 2, 8 * x.numel(),
        "float32", shape,
        lib=lambda a, c, e: F.layer_norm(a, (d,), c, e, 1e-5))
    bk, h, hd, s = len(GPT_LENS) * GPT_BEAMS, 25, 64, max(GPT_LENS)
    ml = s + GPT_NEW
    lens = torch.tensor(GPT_LENS, device=dev).repeat_interleave(GPT_BEAMS)
    j = torch.arange(ml, device=dev)[None, :]
    keep = ((j >= s - lens[:, None]) & (j < s + 8))[:, None, None, :]
    madd = A.additive_mask(keep, bk, h, 1, ml)
    sets = [tuple(torch.randn(bk, m, h, hd, device=dev, generator=g).bfloat16()
                  for m in (1, ml, ml)) for _ in range(3)]
    sc = hd ** -0.5
    shape = (f"q[{bk}, 1, {h}, {hd}] k, v[{bk}, {ml}, {h}, {hd}] bfloat16, "
             "bool padding mask")
    # q and out, K and V only at the key slots the mask keeps (a masked
    # key adds nothing to the output), the mask and lse
    pairs = int(keep.sum()) * h
    nbytes = (2 * sets[0][0].numel() + 2 * hd * pairs) * 2 \
        + madd.numel() * 4 + bk * h * 4
    rows["flash_fwd"] = dtype_row(
        torch, f"flash_fwd GPT-2 XL static decode {shape}",
        lambda q, k, v: A.flash_attention_kernel(q, k, v, sc, False,
                                                 madd)[0],
        lambda q, k, v: A.flash_attention_plain(q, k, v, sc, False, madd),
        sets, TOL["bfloat16"], nbytes, 4 * hd * pairs,
        "bfloat16", shape,
        lib=lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=keep, scale=sc))
    return rows


def gpt_phase(torch, dev, seed, card, layers=48):
    """GPT at GPT-2 XL's published widths (48 layers, bf16, random
    weights from a seed): greedy, sampled and beam search over 4
    left-padded prompts of 17-300 tokens, 32 new tokens, through
    ``generate()``'s static route. Each signature's eager first call is
    captured and replayed bit for bit; the launches are the route's
    (2L + 1 ``layer_norm`` and L ``flash_fwd`` a forward, one
    ``categorical_rows`` a sampled step). Then ``examples/llm_serve.py``
    on the card. Returns each route's launches."""
    from paddle_tpu_torch.examples import llm_serve
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.gpt2_xl(num_hidden_layers=layers, dtype="bfloat16")
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed + 21)).eval()
    torch.cuda.synchronize()
    log(f"gpt: GPT-2 XL widths (hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads of 64, inner "
        f"{cfg.intermediate_size}, vocab {cfg.vocab_size}), {layers} of 48 "
        f"layers, bf16, random weights (seed {seed + 21}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    ids, mask = left_padded(torch, cfg.vocab_size, GPT_LENS,
                            torch.Generator().manual_seed(seed + 22))
    b = len(GPT_LENS)
    routes = {"greedy": {},
              "sampled": dict(decode_strategy="sampling", temperature=0.8,
                              top_p=0.9, seed=seed + 7),
              "beam": dict(decode_strategy="beam_search",
                           num_beams=GPT_BEAMS, length_penalty=0.6)}
    res = {}
    for name, kw in routes.items():
        want = {"layer_norm": GPT_NEW * (2 * layers + 1),
                "flash_fwd": GPT_NEW * layers,
                "categorical_rows": GPT_NEW if name == "sampled" else 0}
        _, pre_e, pre_r, cap_pre, _ = graph_run(
            torch, lambda: model.generate(ids, attention_mask=mask,
                                          max_new_tokens=1, **kw),
            f"GPT {name} prefill")
        torch.cuda.reset_peak_memory_stats()
        (toks, scores), t_e, t_r, cap, counts = graph_run(
            torch, lambda: model.generate(ids, attention_mask=mask,
                                          max_new_tokens=GPT_NEW, **kw),
            f"GPT {name}", want)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(tuple(toks.shape) == (b, GPT_NEW)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
              and bool(torch.isfinite(scores).all()),
              f"GPT {name}: tokens {tuple(toks.shape)}, scores "
              f"{scores.tolist()}")
        rows = b * (GPT_NEW - 1)
        res[name] = dict(counts=counts, toks=toks,
                         tok_s_eager=rows / (t_e - pre_e),
                         tok_s=rows / (t_r - pre_r), capture_s=cap_pre + cap,
                         peak=peak)
        log(f"gpt {name} on {card}: decode eager "
            f"{res[name]['tok_s_eager']:.1f} | replayed "
            f"{res[name]['tok_s']:.1f} tok/s; whole call {t_e * 1e3:.1f} | "
            f"{t_r * 1e3:.1f} ms (prefill {pre_e * 1e3:.1f} | "
            f"{pre_r * 1e3:.1f}); capture {cap_pre + cap:.2f} s; peak "
            f"{peak:.2f} GiB; replays and eager runs equal the first call bit for bit; "
            f"launches {want}")
    check(not torch.equal(res["greedy"]["toks"], res["sampled"]["toks"]),
          "GPT: the sampled tokens equal the greedy ones")
    model._gen_cache.clear()
    del model
    free_card(torch)
    t0 = time.perf_counter()
    out = llm_serve.main([])
    check(out["predictor_err"] <= TOL["float32"]["atol"],
          f"llm_serve: the exported program's logits differ from the live "
          f"model's by {out['predictor_err']:.3e}")
    log(f"examples/llm_serve.py on {card} ended OK in "
        f"{time.perf_counter() - t0:.1f} s")
    return res


def gpt_f32_gate(torch, dev, seed):
    """GPT-2 XL widths at 2 layers in f32, card against CPU: the static
    route greedy and sampled, and beam search on the static and the
    eager route, over a left-padded batch, token for token."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.gpt2_xl(num_hidden_layers=2)
    # eval: GPT's dropout (0.1) would draw on the eager route otherwise
    cpu = GPTForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed + 23)).eval()
    gpu = GPTForCausalLM(cfg, device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(1, cfg.vocab_size, (3, 40),
                        generator=torch.Generator().manual_seed(
                            seed + 24)).numpy()
    mask = np.ones_like(ids)
    mask[1, :17] = 0
    mask[2, 31:] = 0
    f32_token_gate(torch, "GPT-2 XL widths", cpu, gpu, ids, mask, seed)
    gpu._gen_cache.clear()
    del cpu, gpu


def f32_token_gate(torch, label, cpu, gpu, ids, mask, seed, eos=None):
    """Card against CPU on one batch: greedy, sampled (and with ``eos``
    eos, min_new_tokens and a repetition penalty), beam search on the
    static route and on the eager route; tokens equal."""
    beam = dict(decode_strategy="beam_search", num_beams=4,
                length_penalty=0.6)
    sampled = dict(decode_strategy="sampling", temperature=0.8, top_k=50,
                   top_p=0.9, seed=seed + 3)
    cases = {"greedy": {}, "sampled (top-k, top-p)": sampled,
             "beam, static route": beam,
             "beam, eager route": dict(beam, use_cache=False)}
    if eos is not None:
        cases["sampled (top-k, top-p, eos, min_new_tokens 2, repetition "
              "1.2)"] = dict(sampled, eos_token_id=eos, min_new_tokens=2,
                             repetition_penalty=1.2)
        cases["beam with eos and min_new_tokens 2"] = dict(
            beam, eos_token_id=eos, min_new_tokens=2)
    for name, kw in cases.items():
        want = cpu.generate(ids, attention_mask=mask, max_new_tokens=8, **kw)
        got = gpu.generate(ids, attention_mask=mask, max_new_tokens=8, **kw)
        log(f"infer (d) f32 2-layer {label}, {name}: card == CPU "
            f"{torch.equal(got[0], want[0])}; score max_abs_err "
            f"{float((got[1] - want[1]).abs().max()):.3e}")
        check(torch.equal(got[0], want[0]),
              f"{label} {name}: card {got[0].tolist()} vs CPU "
              f"{want[0].tolist()}")


def perturb_in_place(torch, model, seed):
    """Add seeded noise to every weight in place (``add_``: the version
    counters move, the addresses stay), as loading a checkpoint in place
    does."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g,
                                      device=model.device, dtype=p.dtype))


# ------------------------------------------------------------------- AOT --

# the aot phase's bundles: run 1's block-table geometry, and runs 2-3's
# (ragged decode, chunk 256, 4 drafts, sampling enabled: run 2 serves its
# greedy prompts on it). The prompt buckets are the power-of-two chain the
# eager runs bucket by (a warm predictor buckets by its bundle's table),
# up to the longest unchunked prompt; serving the runs' prompts once (2
# tokens each) records the shared prompt's suffix prefill, which no
# bucket steers
AOT_BUNDLES = {"run1": (RUN1, (32, 64, 128, 256, 512)),
               "run23": (RUN3, (32, 64, 128, 256))}
AOT_MISS_LEN = 600           # bucket 1024: past run 1's bundle's table
AOT_DIR = os.path.join("output", "chip_smoke_aot")
AOT_CHILD_TIMEOUT = 600


def weight_sum(torch, model):
    """An f64 sum of every weight's f32 sum: equal in two processes only
    when the seeded weights are."""
    with torch.no_grad():
        return float(torch.stack([p.float().sum()
                                  for p in model.parameters()])
                     .double().sum())


def aot_phase(torch, dev, seed, layers, card, serve):
    """The AOT engine at full width: both bundles built from the serve
    phase's model (then freed), the f32 gate in this process, and a
    second process that warm-starts from the bundles with an empty default
    kernel build directory (``aot_child``), whose runs 1-3 must give this
    process's eager tokens, stats and launch counts."""
    import collections
    from paddle_tpu_torch.inference import aot
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), AOT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    model, prompts, reps = serve["model"], serve["prompts"], serve["reps"]
    bundles = {}
    for name, (kw, buckets) in AOT_BUNDLES.items():
        b = aot.EngineBuilder(model, prompt_buckets=buckets,
                              batch_sizes=(1, 2, 4), **GEOM, **kw)
        b.add_traffic(prompts, max_new_tokens=2)
        bundles[name] = os.path.join(root, name)
        man = b.build(bundles[name], seed=seed)
        torch.cuda.synchronize()
        kinds = collections.Counter(r["kind"]
                                    for r in man["artifacts"].values())
        mib = sum(r["bytes"] for r in man["kernels"].values()) / 2**20
        log(f"aot: bundle {name} ({kw}, prompt buckets {buckets}) built in "
            f"{b.build_seconds:.1f} s on {card}: {len(man['artifacts'])} "
            f"signatures {dict(kinds)}; {len(man['kernels'])} kernel files "
            f"({mib:.1f} MiB)")
        check(kinds["decode_sample" if kw.get("sampling_enabled")
                    else "decode"] == 1 and kinds["suffix"] >= 1,
              f"bundle {name} lacks a decode or suffix program: {kinds}")
    wsum = weight_sum(torch, model)
    del model, serve["model"], b
    free_card(torch)
    aot_f32_gate(torch, dev, seed, root, card)
    free_card(torch)

    spec = {"seed": seed, "layers": layers, "weight_sum": wsum,
            "bundles": bundles, "prompts": prompts, "reps": reps,
            "max_new": serve["max_new"],
            "stream_outs": serve["front"]["stream_outs"],
            "result": os.path.join(root, "child.json"),
            "empty_build": os.path.join(root, "empty_build")}
    os.makedirs(spec["empty_build"])
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PADDLE_TPU_TORCH_BUILD_DIR=spec["empty_build"])
    env.pop("TRITON_CACHE_DIR", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--aot-child",
         os.path.join(root, "spec.json")], env=env,
        timeout=AOT_CHILD_TIMEOUT)
    check(proc.returncode == 0,
          f"the warm-start process failed (exit {proc.returncode})")
    log(f"aot: the warm-start process took {time.perf_counter() - t0:.1f} s")
    with open(spec["result"]) as f:
        res = json.load(f)
    names = ("run 1", "run 2", "run 3")
    for i, (name, eager, warm) in enumerate(zip(names, serve["runs"],
                                                res["runs"])):
        diff = [r for r, (a, b) in enumerate(zip(eager["outs"],
                                                 warm["outs"])) if a != b]
        same = "n/a (the sampling bundle's ticks draw)" if i == 1 else \
            warm["counts"] == eager["counts"]
        log(f"aot {name}: graph tokens vs eager: requests that differ "
            f"{diff}; stats equal: {warm['stats'] == eager['stats']}; "
            f"launch counts equal: {same}")
        check(not diff, f"{name} through graphs gives other tokens for "
              f"{diff} than eager")
        check(warm["stats"] == eager["stats"],
              f"{name} stats: graphs {warm['stats']} vs eager "
              f"{eager['stats']}")
        if i != 1:   # run 2 ran on the sampling-enabled predictor
            check(warm["counts"] == eager["counts"],
                  f"{name} launch counts: graphs {warm['counts']} vs "
                  f"eager {eager['counts']}")
        if i == 2:
            check(warm["sampling_stats"] == eager["sampling_stats"],
                  f"run 3 sampling stats: graphs {warm['sampling_stats']} "
                  f"vs eager {eager['sampling_stats']}")
        tick = lambda r: ", ".join(f"{k} {v:.0f}"            # noqa: E731
                                   for k, v in r.get("tick", {}).items())
        log(f"aot {name} on {card}, eager | graphs: decode "
            f"{eager['tok_s']:.1f} | {warm['tok_s']:.1f} tok/s; TTFT p50 "
            f"{eager['ttft_p50_ms']:.1f} | {warm['ttft_p50_ms']:.1f} ms; "
            f"idle share {eager['idle']:.3f} | {warm['idle']:.3f}; host ops "
            f"per decode step {eager['host_per_step']:.0f} | "
            f"{warm['host_per_step']:.0f}; device activities per tick "
            f"[{tick(eager) or 'not measured'}] | "
            f"[{tick(warm) or 'not measured'}]; peak memory "
            f"{eager['peak_gib']:.2f} | {warm['peak_gib']:.2f} GiB (graph "
            f"pool included); capture at warm start "
            f"{warm['capture_s']:.2f} s ({warm['loads']} programs)")
    shutil.rmtree(root, ignore_errors=True)
    return res


def aot_f32_gate(torch, dev, seed, root, card):
    """2 layers at full width in f32: a warm-started predictor on the
    card gives the CPU eager predictor's tokens and stats."""
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor, aot
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(seed + 3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (40, 37, 21)]
    geom = dict(max_batch_size=2, page_size=16, max_seq_len=128)
    path = os.path.join(root, "f32")
    b = aot.EngineBuilder(gpu, prompt_buckets=(32, 64), **geom)
    b.build(path, seed=seed)
    pred, eng = aot.warm_start(gpu, path, strict=True)
    got = pred.generate(prompts, max_new_tokens=6)
    want_cb = ContinuousBatchingPredictor(cpu, device="cpu", **geom)
    want = want_cb.generate(prompts, max_new_tokens=6)
    log(f"aot f32 gate on {card}: 2 layers at full width, warm-started "
        f"tokens == CPU eager: {got == want}; stats equal: "
        f"{pred.stats == want_cb.stats}; {eng.stats['loads']} programs, "
        f"{eng.stats['hits']} hits, {eng.stats['misses']} misses")
    check(got == want, f"f32 warm-started tokens {got} vs CPU {want}")
    check(pred.stats == want_cb.stats,
          f"f32 stats: card {pred.stats} vs CPU {want_cb.stats}")
    check(eng.stats["misses"] == 0 and eng.stats["hits"] > 0,
          f"f32 warm start missed: {eng.stats}")
    f1_gate(torch, dev, gpu, prompts, seed, "warm-started engine", pred)
    check(eng.stats["misses"] == 0, f"the F1 gate missed: {eng.stats}")


def aot_warm(torch, aot, model, path, card, label):
    """A strict warm start (any invalidation raises); logs its time."""
    t0 = time.perf_counter()
    pred, eng = aot.warm_start(model, path, strict=True)
    torch.cuda.synchronize()
    log(f"aot child: warm start of {label} on {card}: {eng.stats['loads']} "
        f"programs captured in {eng.stats['capture_s']:.2f} s "
        f"({time.perf_counter() - t0:.2f} s in all)")
    check(eng.warm and eng.stats["loads"] > 0, f"{label}: a cold bundle")
    return pred, eng


def telemetry_reset():
    """Empty the observability registry and flight ring before a serve
    whose telemetry a gate reads."""
    from paddle_tpu_torch import observability as obs
    obs.get_registry().reset()
    obs.flight_recorder().clear()


def telemetry_gate(cb, label, stats0, aot_counters=None):
    """After one serve on a registry emptied just before it
    (``telemetry_reset``): every registry counter equals its ``stats``
    twin (the change of ``stats`` over the serve), completed requests by
    status equal ``last_status``, the flight ring holds one
    ``serve.request`` span per request, ended with its status and with
    its events; with ``aot_counters`` the ``aot.bundle_hits`` and
    ``aot.bucket_misses`` series equal the engine's counters and
    ``serve.cold_start_seconds`` reads ``mode="warm"``."""
    import collections
    from paddle_tpu_torch import observability as obs
    reg = obs.get_registry()

    def total(name, unlabelled=False, **want):
        m = reg.get(name)
        return 0.0 if m is None else sum(
            s._value for s in m.series()
            if all(s._labels.get(k) == v for k, v in want.items())
            and not (unlabelled and "kind" in s._labels))
    d = {k: cb.stats[k] - stats0[k] for k in stats0}
    twins = {
        "decode_steps": (total("serving.decode_steps"), d["decode_steps"]),
        "admissions": (total("serving.admissions"), d["prefills"]
                       + d["prefix_hits"] + d["chunked_requests"]),
        "prefix_hits": (total("serving.prefix_cache_hits",
                              unlabelled=True), d["prefix_hits"]),
        "prefix_partial_hits": (total("serving.prefix_cache_hits",
                                      kind="partial"),
                                d["prefix_partial_hits"]),
        "prefix_misses": (total("serving.prefix_cache_misses"),
                          d["prefix_misses"]),
        "spec_proposed": (total("serving.spec.proposed_tokens"),
                          d["spec_proposed"]),
        "spec_accepted": (total("serving.spec.accepted_tokens"),
                          d["spec_accepted"]),
        "prefill_chunks": (total("serving.chunked_prefill.chunks"),
                           d["prefill_chunks"]),
        "chunked_requests": (total("serving.chunked_prefill.requests"),
                             d["chunked_requests"]),
        "evictions": (total("serving.evictions"), d["evictions"])}
    for st, n in collections.Counter(cb.last_status).items():
        twins[f"completed {st}"] = (
            total("serving.completed_requests", status=st), n)
    bad = {k: v for k, v in twins.items() if v[0] != v[1]}
    spans = [s for s in obs.flight_recorder().spans()
             if s["name"] == "serve.request"]
    by_idx = {s["labels"]["idx"]: s for s in spans}
    n = len(cb.last_status)
    span_ok = (len(spans) == n and sorted(by_idx) == list(range(n))
               and all(by_idx[r]["status"] == cb.last_status[r]
                       and by_idx[r]["events"][0]["name"] == "queued"
                       and by_idx[r]["events"][-1]["name"]
                       == ("finish" if cb.last_status[r] == "ok"
                           else cb.last_status[r]) for r in range(n)))
    events = sum(len(s["events"]) for s in spans)
    log(f"telemetry {label}: {len(twins)} registry counters vs their stats "
        f"twins, {len(bad)} differ {bad or ''}; {len(spans)} serve.request "
        f"spans for {n} requests ({events} events)")
    check(not bad, f"{label}: registry counters differ from stats: {bad}")
    check(span_ok, f"{label}: not one ended serve.request span with its "
          f"events per request ({len(spans)} spans)")
    if aot_counters is not None:
        def series(name):
            m = reg.get(name)
            return {} if m is None else {s._labels["kind"]: s._value
                                         for s in m.series()}
        hits, miss = series("aot.bundle_hits"), series("aot.bucket_misses")
        cold = reg.get("serve.cold_start_seconds")
        modes = [] if cold is None else [s._labels.get("mode")
                                         for s in cold.series()]
        log(f"telemetry {label}: aot.bundle_hits {hits}, aot.bucket_misses "
            f"{miss}; serve.cold_start_seconds modes {modes} "
            f"({[round(s._value, 3) for s in cold.series()] if cold else []}"
            f" s)")
        check(hits == dict(aot_counters["bundle_hits"])
              and miss == dict(aot_counters["bucket_misses"]),
              f"{label}: aot series {hits} / {miss} vs the engine's "
              f"counters {dict(aot_counters['bundle_hits'])} / "
              f"{dict(aot_counters['bucket_misses'])}")
        check(modes == ["warm"], f"{label}: serve.cold_start_seconds "
              f"modes {modes}")


def aot_counted(torch, dev, aot, model, cfg, card, label, required, kw,
                pred, eng, prompts, max_new, sampling=None):
    """One counted run through graphs: no bucket miss, bundle hits,
    every required kernel counted by replay; its telemetry held to its
    stats and to the engine's counters (``telemetry_gate``)."""
    from paddle_tpu_torch import observability as obs
    aot.reset_counters()
    telemetry_reset()
    stats0 = dict(pred.stats)
    hits0 = eng.stats["hits"]
    r = serve_run(torch, dev, model, cfg, prompts, max_new, card, label,
                  required, kw, sampling, cb=pred)
    misses = dict(aot.counters["bucket_misses"])
    log(f"aot child {label}: bundle hits {eng.stats['hits'] - hits0} "
        f"{dict(aot.counters['bundle_hits'])}, bucket misses {misses}")
    check(not misses and eng.stats["hits"] > hits0,
          f"{label}: a bucket miss or no bundle hit: {misses}")
    telemetry_gate(pred, label, stats0, aot.counters)
    obs.maybe_export()
    r.update(capture_s=eng.stats["capture_s"], loads=eng.stats["loads"])
    return r


def telemetry_ab(torch, pred, prompts, max_new, want, card, label,
                 sampling=None):
    """The telemetry's cost on a replayed run: the run with telemetry on,
    off, off, on (``observability.scoped``), each from an empty prefix
    cache and giving ``want``'s tokens. Per run: decode tokens/s outside
    monolithic prefill, TTFT p50, and host microseconds per decode tick
    (the wall time outside prefill less the time spent waiting for the
    steps' results, over the decode steps). Printed, not gated."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference import predictor as P
    real = P._Fetch.__call__
    res = {True: [], False: []}
    sink = obs.telemetry_path()
    obs.configure(None)       # as served by default: no JSONL sink
    for on in (True, False, False, True):
        wait = [0.0]

        def timed(self):
            t = time.perf_counter()
            try:
                return real(self)
            finally:
                wait[0] += time.perf_counter() - t
        pred.prefix_cache.clear(pred.pool)
        prefill_s = time_prefills(pred)
        steps0 = pred.stats["decode_steps"]
        P._Fetch.__call__ = timed
        try:
            with obs.scoped(on):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = pred.generate(prompts, max_new_tokens=max_new,
                                     sampling=sampling)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            P._Fetch.__call__ = real
            untime_prefills(pred)
        check(outs == want, f"{label} with telemetry "
              f"{'on' if on else 'off'}: other tokens")
        steps = pred.stats["decode_steps"] - steps0
        dec_s = max(wall - prefill_s[0], 1e-9)
        dec_tok = sum(len(o) for o in outs) - len(outs)
        res[on].append({"tok_s": dec_tok / dec_s,
                        "ttft_p50_ms": statistics.median(
                            pred.last_ttft_s) * 1e3,
                        "host_us": (dec_s - wait[0]) / max(steps, 1) * 1e6})
    obs.configure(sink)

    def fmt(k, f):
        return " | ".join(f"{statistics.mean(r[k] for r in res[on]):{f}} "
                          f"({', '.join(format(r[k], f) for r in res[on])})"
                          for on in (True, False))
    log(f"telemetry A/B {label} on {card}, on | off (mean (each run), order "
        f"on off off on): decode {fmt('tok_s', '.1f')} tok/s; TTFT p50 "
        f"{fmt('ttft_p50_ms', '.1f')} ms; host {fmt('host_us', '.0f')} us "
        f"per decode tick")
    return {on: res[on] for on in (True, False)}


def aot_streams(torch, dev, aot, model, cfg, card, pred, eng, prompts,
                max_new, eager_outs):
    """(g): run 1's requests through replayed graphs, by generate(),
    streamed, and streamed with the watchdog armed at 30 s
    (``FLAGS_serve_decode_watchdog_s``: the bundle's config leaves it
    unset), in the order g s w w s g, each from an empty prefix cache:
    the eager stream's tokens, no bucket miss. Returns each mode's
    decode tok/s and first-token p50s."""
    from paddle_tpu_torch.framework import flags
    modes = ("generate", "stream", "armed", "armed", "stream", "generate")
    rates = {m: [] for m in modes}
    firsts = {m: [] for m in modes}
    for mode in modes:
        pred.prefix_cache.clear(pred.pool)
        aot.reset_counters()
        flags.set_flags({"serve_decode_watchdog_s":
                         30.0 if mode == "armed" else 0.0})
        try:
            if mode == "generate":
                res = serve_run(torch, dev, model, cfg, prompts, max_new,
                                card, "(g) run 1 through graphs",
                                RUN1_KERNELS, RUN1, cb=pred)
                firsts[mode].append(res["ttft_p50_ms"])
            else:
                res = stream_run(
                    torch, dev, model, prompts, max_new, card,
                    f"(g) run 1 streamed through graphs, watchdog "
                    f"{'armed at 30 s' if mode == 'armed' else 'unarmed'}",
                    cb=pred, required=RUN1_KERNELS)
                firsts[mode].append(statistics.median(res["first_ms"]))
        finally:
            flags.set_flags({"serve_decode_watchdog_s": 0.0})
        misses = dict(aot.counters["bucket_misses"])
        check(res["outs"] == eager_outs,
              f"(g) {mode} through graphs differs from the eager stream")
        check(not misses, f"(g) {mode} through graphs missed: {misses}")
        check((pred._wd_cur == 30.0) == (mode == "armed"),
              f"the watchdog flag did not arm the serve: {pred._wd_cur}")
        rates[mode].append(res["tok_s"])
    mean = {m: statistics.mean(v) for m, v in rates.items()}
    log(f"aot child (g) on {card}: run 1 through graphs, the eager "
        f"stream's tokens in every run, no bucket miss; decode tok/s "
        f"generate() {rates['generate']}, streamed {rates['stream']}, "
        f"streamed with the watchdog armed at 30 s {rates['armed']} (means "
        f"{mean['generate']:.1f} / {mean['stream']:.1f} / "
        f"{mean['armed']:.1f}); TTFT p50 of generate() {firsts['generate']}"
        f" ms, first-event p50 streamed {firsts['stream']} and armed "
        f"{firsts['armed']} ms")
    return {"g_rates": rates, "g_firsts": firsts}


def aot_child(torch, dev, spec_path, card):
    """The second process of the aot phase: warm-starts from the bundles
    (the default kernel build directory empty), serves runs 1-3 through
    graphs with their profiled passes and ticks, a bucket miss and a
    second warm start, and writes the results for the first process."""
    import collections
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor, aot
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    with open(spec_path) as f:
        spec = json.load(f)
    # spans and one registry snapshot per counted run go to a JSONL sink
    tel_path = os.path.join(os.path.dirname(spec["result"]),
                            "telemetry.jsonl")
    obs.configure(tel_path)
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=spec["layers"],
                                dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(spec["seed"]))
    check(weight_sum(torch, model) == spec["weight_sum"],
          "the second process drew other weights from the seed")
    prompts, reps, max_new = spec["prompts"], spec["reps"], spec["max_new"]
    runs = []

    def keep(r):
        r.pop("cb", None)
        r.pop("dtype_counts", None)     # tuple keys: not JSON
        runs.append(r)

    # run 1 on the block-table bundle, then a bucket miss there
    pred, eng = aot_warm(torch, aot, model, spec["bundles"]["run1"], card,
                         "bundle run1")
    r = aot_counted(torch, dev, aot, model, cfg, card, "run 1 (graphs)",
                    RUN1_KERNELS, RUN1, pred, eng, prompts, max_new)
    r.update(serve_profile(torch, dev, model, prompts[:4], card, RUN1,
                           cb=pred))
    r["tick"] = tick_launches(torch, dev, pred, card, "run 1 (graphs)")
    r.update(aot_streams(torch, dev, aot, model, cfg, card, pred, eng,
                         prompts, max_new, spec["stream_outs"]))
    r["ab"] = telemetry_ab(torch, pred, prompts, max_new, r["outs"], card,
                           "run 1 (graphs)")
    keep(r)
    gen = torch.Generator().manual_seed(spec["seed"] + 4)
    miss = [torch.randint(1, cfg.vocab_size, (AOT_MISS_LEN,),
                          generator=gen).tolist()]
    want = ContinuousBatchingPredictor(model, device=dev, **GEOM,
                                       **RUN1).generate(miss, 8)
    aot.reset_counters()
    n0 = len(aot.EngineBundle(spec["bundles"]["run1"]).artifacts())
    got = pred.generate(miss, max_new_tokens=8)
    m_after = len(aot.EngineBundle(spec["bundles"]["run1"]).artifacts())
    log(f"aot child: a {AOT_MISS_LEN}-token prompt: bucket misses "
        f"{dict(aot.counters['bucket_misses'])}, write-backs "
        f"{eng.stats['write_backs']}, programs in the bundle {n0} -> "
        f"{m_after}; tokens == eager: {got == want}")
    check(dict(aot.counters["bucket_misses"]) == {"prefill": 1}
          and eng.stats["write_backs"] == 1 and m_after == n0 + 1,
          f"the uncalibrated bucket did not miss once and write back: "
          f"{dict(aot.counters['bucket_misses'])}, {eng.stats}")
    check(got == want, f"the missed bucket's tokens {got} vs eager {want}")
    del pred, eng
    free_card(torch)
    pred, eng = aot_warm(torch, aot, model, spec["bundles"]["run1"], card,
                         "bundle run1 after the write-back")
    aot.reset_counters()
    again = pred.generate(miss, max_new_tokens=8)
    log(f"aot child: the written-back bucket after a second warm start: "
        f"bundle hits {dict(aot.counters['bundle_hits'])}, misses "
        f"{dict(aot.counters['bucket_misses'])}; tokens == eager: "
        f"{again == want}")
    check(again == want and not aot.counters["bucket_misses"]
          and aot.counters["bundle_hits"]["prefill"] >= 1,
          "the second warm start did not hit the written-back bucket")
    del pred, eng
    free_card(torch)

    # run 2 (greedy) and run 3 on the sampling-enabled bundle, each on a
    # fresh warm start
    for label, required, kw, sampling in (
            ("run 2 (graphs)", RUN2_KERNELS, RUN2, None),
            ("run 3 (graphs)", RUN3_KERNELS, RUN3, run3_sampling())):
        pred, eng = aot_warm(torch, aot, model, spec["bundles"]["run23"],
                             card, f"bundle run23 for {label[:5]}")
        r = aot_counted(torch, dev, aot, model, cfg, card, label, required,
                        kw, pred, eng, prompts + reps, max_new + [64, 64],
                        sampling)
        if sampling is None:
            r["ab"] = telemetry_ab(torch, pred, prompts + reps,
                                   max_new + [64, 64], r["outs"], card,
                                   label)
            r.update(serve_profile(torch, dev, model,
                                   [prompts[0], prompts[1], reps[0],
                                    prompts[3]], card, kw, cb=pred))
        else:
            allp = prompts + reps
            r.update(serve_profile(torch, dev, model,
                                   [allp[i] for i in RUN3_PICK], card, kw,
                                   [sampling[i] for i in RUN3_PICK],
                                   cb=pred))
            r["tick"] = tick_launches(torch, dev, pred, card, label)
        keep(r)
        del pred, eng
        free_card(torch)
    obs.configure(None)
    with open(tel_path) as f:
        recs = [json.loads(x) for x in f]
    kinds = collections.Counter(r.get("kind") for r in recs)
    prom = obs.PrometheusExporter().render().splitlines()
    log(f"aot child telemetry: {len(recs)} JSONL records ({kinds['span']} "
        f"spans, {len(recs) - kinds['span']} samples); "
        f"PrometheusExporter().render(): {len(prom)} lines")
    check(kinds["span"] > 0 and len(recs) > kinds["span"] and prom,
          "the JSONL sink or the Prometheus text is empty")
    left = os.listdir(spec["empty_build"])
    log(f"aot child: nvcc runs in this process: {_build.build_stats['nvcc']}"
        f"; files in the default build directory: {len(left)}")
    check(_build.build_stats["nvcc"] == 0 and not left,
          "the warm-start process built a kernel")
    with open(spec["result"], "w") as f:
        json.dump({"runs": runs}, f)
    return 0


# ---------------------------------------------------------- fine-tuning --

# launches of each kernel per fine-tuning step of a 12-layer encoder: the
# embedding LayerNorm and two per layer; one flash forward and one of each
# backward kernel per layer
FINETUNE_KERNELS = ("layer_norm", "flash_fwd", "flash_bwd_dkdv",
                    "flash_bwd_dq")


def finetune_kernels_per_step(layers):
    # the example's AdamW has no clip: one fused_update, no grad_sq_norm
    return {"layer_norm": 2 * layers + 1, "flash_fwd": layers,
            "flash_bwd_dkdv": layers, "flash_bwd_dq": layers,
            "fused_update": 1, "grad_sq_norm": 0}


F32_PEAK = 67e12                    # f32 outside the tensor cores
BERT_GATE_TOL = dict(atol=1e-3, rtol=1e-3)


def bert_gate_run(torch, model, batch, seed, steps=3):
    """Eval logits, then ``steps`` steps of the example's loop (its AdamW
    and schedule, lr 3e-5 over 30 steps) on one batch with the port's
    random state reset to ``seed``: (logits, losses, {parameter: step-1
    gradient}) on the CPU."""
    from paddle_tpu_torch.examples import bert_finetune as ex
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.nn import CrossEntropyLoss
    ids, labels, mask = ex.to_device(batch, model.device)
    model.eval()
    with torch.no_grad():
        logits = model(ids, attention_mask=mask).cpu()
    model.train()
    prandom.seed(seed)
    opt = ex.build_optimizer(model, 3e-5, 30)
    crit = CrossEntropyLoss()
    losses, grads = [], None
    for i in range(steps):
        loss = crit(model(ids, attention_mask=mask), labels)
        loss.backward()
        if i == 0:
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        opt._learning_rate.step()
        losses.append(float(loss.detach()))
    return logits, losses, grads


def grad_layer(name):
    """The layer a parameter belongs to: its name up to the last numeric
    component (``bert.encoder.layers.3``), else the parameter itself."""
    parts = name.split(".")
    nums = [i for i, p in enumerate(parts) if p.isdigit()]
    return ".".join(parts[:nums[-1] + 1]) if nums else name


def bert_f32_gate(torch, dev, seed):
    """BERT-base at full width (12 layers, hidden 768, 12 heads of 64), f32,
    the same weights on the card (kernels) and the CPU (plain versions),
    one batch of 2 x 128 with row lengths 128 and 77: eval logits within
    1e-3; then 3 steps with attention dropout 0.1 (the same host seeds on
    both) and hidden dropout 0: losses within rtol 1e-4, step-1 gradients
    per tensor within 1e-3 of the tensor's largest CPU value. A tensor
    whose largest CPU gradient is at rounding level (below 1e-4 of the
    largest in its layer) is measured against its layer's largest
    instead: the key projections' biases are such, their gradient is 0
    in exact arithmetic (softmax ignores a shift shared by a row's
    scores), so both sides hold rounding noise only. The tensors that
    took that rule are logged."""
    from paddle_tpu_torch.examples import bert_finetune as ex
    from paddle_tpu_torch.models import (BertConfig,
                                         BertForSequenceClassification)
    cfg = BertConfig(num_labels=ex.NUM_CLASSES, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.1)
    cpu = BertForSequenceClassification(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    gpu = BertForSequenceClassification(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rng = torch.Generator().manual_seed(seed + 5)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), generator=rng).numpy()
    labels = torch.randint(0, ex.NUM_CLASSES, (2,), generator=rng).numpy()
    mask = (torch.arange(128)[None, :]
            < torch.tensor([128, 77])[:, None]).long().numpy()
    t0 = time.perf_counter()
    lg_gpu, l_gpu, g_gpu = bert_gate_run(torch, gpu, (ids, labels, mask), seed)
    lg_cpu, l_cpu, g_cpu = bert_gate_run(torch, cpu, (ids, labels, mask), seed)
    err = float((lg_gpu - lg_cpu).abs().max())

    top = {n: float(t.abs().max()) for n, t in g_cpu.items()}
    layer_top = {}
    for n, v in top.items():
        layer_top[grad_layer(n)] = max(layer_top.get(grad_layer(n), 0.0), v)
    noise = sorted(n for n, v in top.items()
                   if v < 1e-4 * layer_top[grad_layer(n)])

    def scale(n):
        return max(layer_top[grad_layer(n)] if n in noise else top[n], 1e-30)
    worst = max((float((g_gpu[n] - t).abs().max()) / scale(n), n)
                for n, t in g_cpu.items())
    log(f"f32 BERT-base gate, card vs CPU ({time.perf_counter() - t0:.1f} "
        f"s): eval logits max_abs_err {err:.3e} (atol = rtol = 1e-3); losses "
        f"{l_gpu} vs {l_cpu}; step-1 gradients worst max|card - cpu| / "
        f"max|cpu| {worst[0]:.3e} ({worst[1]}); measured against their "
        f"layer's largest, at rounding level: {noise}")
    check(bool(torch.isfinite(lg_gpu).all()), "BERT logits non-finite")
    check(torch.allclose(lg_gpu, lg_cpu, **BERT_GATE_TOL),
          "BERT eval logits differ between the card and the CPU")
    for i, (a, b_) in enumerate(zip(l_gpu, l_cpu)):
        check(abs(a - b_) <= 1e-4 * abs(b_),
              f"BERT step {i + 1} loss {a} on the card vs {b_} on the CPU")
    check(worst[0] <= 1e-3, f"BERT step-1 gradient of {worst[1]} differs by "
          f"{worst[0]:.3e} of its largest value (limit 1e-3)")


def finetune_run(torch, dev, card, model, steps):
    """One counted fine-tune through the example's ``main`` (batch 16 x
    128, row lengths 32-128, every dropout 0.1): launch counters set to 0
    just before it and read just after. Every loss finite and each kernel
    launched its per-step count every step. Prints step time (median of
    steps 2 on), tokens/s, MFU over the f32 peak and peak memory, then
    profiles one more step. MFU counts 6 N FLOPs per token with N the
    parameters outside the embedding tables, which do no matrix product
    (attention's own products are left out, as 6 N does). Returns the
    run's launch counts."""
    from paddle_tpu_torch.nn.layers_common import Embedding
    from paddle_tpu_torch.examples import bert_finetune as ex
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    res = ex.main(["--model", model, "--steps", str(steps), "--batch", "16",
                   "--seq", "128", "--min-len", "32", "--device", str(dev)])
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    cfg = res["config"]
    n_params = sum(p.numel() for p in res["model"].parameters())
    n_emb = sum(m.weight.numel() for m in res["model"].modules()
                if isinstance(m, Embedding))
    losses, step_s = res["losses"], res["step_s"]
    med = statistics.median(step_s[1:])
    tok_s = res["tokens_per_step"] / med
    log(f"fine-tune {model} (hidden {cfg.hidden_size}, {cfg.num_hidden_layers}"
        f" layers, vocab {cfg.vocab_size}, {n_params / 1e6:.2f} M parameters,"
        f" f32): losses {[round(x, 4) for x in losses]}; step times (s) "
        f"{[round(t, 4) for t in step_s]}; launches {counts}")
    log(f"fine-tune {model} on {card}: step median (steps 2-{steps}) "
        f"{med * 1e3:.2f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{6 * (n_params - n_emb) * tok_s / F32_PEAK:.4f} (6 N tokens/s over"
        f" the f32 peak, {F32_PEAK / 1e12:.0f} TFLOP/s, N = "
        f"{(n_params - n_emb) / 1e6:.2f} M outside the embeddings); peak "
        f"memory "
        f"{peak / 2**30:.2f} GiB")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"non-finite fine-tune loss {losses}")
    want = {k: n * steps for k, n in finetune_kernels_per_step(
        cfg.num_hidden_layers).items()}
    check(all(counts[k] == n for k, n in want.items()),
          f"launches {counts} are not {want} ({steps} steps)")
    finetune_profile(torch, dev, res, card, med * 1e3)
    return counts


def finetune_profile(torch, dev, res, card, step_ms):
    """One more fine-tune step under the profiler (a fresh batch of the
    same shape): device busy and idle share and the device time by
    kernel and by kind. The tracer slows the host, so the idle share is
    given against the traced wall time and against ``step_ms``, the
    untraced step median."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.examples import bert_finetune as ex
    batch = next(ex.synthetic_batches(np.random.RandomState(99),
                                      res["config"].vocab_size, 16, 128,
                                      ex.NUM_CLASSES, 1, 32))
    args = ex.to_device(batch, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = ex.train_step(res["model"], res["optimizer"],
                             res["criterion"], *args)
        float(loss.detach())
        wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernel_ms(torch, prof)
    busy = sum(ms for ms, _ in kern.values())
    log(f"fine-tune profile on {card}: one step, wall {wall:.1f} ms (traced),"
        f" device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f} of the"
        f" traced step, {1 - busy / step_ms:.3f} of the untraced median "
        f"{step_ms:.2f} ms")
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<6d} {name[:90]}")
    cats = {}
    for name, (ms, n) in kern.items():
        cat = next((c for c, keys in TRAIN_OP_CATEGORIES
                    if any(k in name for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    log("fine-tune profile by category: " + ", ".join(
        f"{c} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
        for c, ms in sorted(cats.items(), key=lambda kv: -kv[1])))
    from torch.autograd import DeviceType
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    log(f"fine-tune profile: host ops {host_ms:.1f} ms of self time "
        f"({sum(e.count for e in host)} calls); top by self time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"  {e.self_cpu_time_total / 1e3:9.2f} ms x{e.count:<6d} "
            f"{e.key[:60]}")


# ------------------------------------------------------------ training --

# launches of each kernel per training step of an L-layer Llama: RMSNorm
# twice per layer plus the final norm; one flash forward and one of each
# backward kernel per layer; one fused optimizer update and one gradient
# norm (the global-norm clip) per step
def train_kernels_per_step(layers):
    return {"rms_norm": 2 * layers + 1, "flash_fwd": layers,
            "flash_bwd_dkdv": layers, "flash_bwd_dq": layers,
            "fused_update": 1, "grad_sq_norm": 1}


def _adamw(model, lr, epsilon=1e-8):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=lr, epsilon=epsilon, weight_decay=0.1,
                 parameters=model.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))


# the f32 training gate's AdamW. At lr 1e-4 one step memorizes the single
# batch (loss 11.2 -> 1.8e-3), whose tiny losses no backend reproduces to
# 1e-4; at eps 1e-8 Adam's first step, lr*g/(|g| + eps), turns the
# backends' ~1e-10 gradient rounding into lr-sized moves of the weights
# whose gradient is near 0 (slope lr/eps at g = 0). lr 1e-5 keeps the
# loss near its start and eps 1e-6 bounds that slope at 10
F32_TRAIN_LR, F32_TRAIN_EPS = 1e-5, 1e-6
# card vs CPU after 3 steps, each tensor's max |difference| over its own
# largest CPU value: step-1 gradients, the 3 steps' weight change, and
# both moments
F32_TRAIN_TOL = {"gradient": 1e-3, "update": 1e-2, "moment1": 1e-3,
                 "moment2": 1e-3}


def f32_train_run(torch, model, ids, lr, eps, steps=3):
    """``steps`` TrainSteps of AdamW (wd 0.1, global-norm clip 1.0) on
    one batch: (losses, {kind: {parameter: CPU tensor}}) with the step-1
    gradients, the weight change over all steps and the moments after
    them."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    crit = LlamaPretrainingCriterion()
    step = TrainStep(model, _adamw(model, lr, eps),
                     lambda lg, lb: crit(lg, lb))
    named = dict(model.named_parameters())
    p0 = {n: p.detach().cpu().clone() for n, p in named.items()}
    losses, out = [], {}
    for i in range(steps):
        losses.append(float(step(ids, ids)))
        if i == 0:
            out["gradient"] = {n: p.grad.detach().cpu()
                               for n, p in named.items()}
    out["update"] = {n: p.detach().cpu() - p0[n] for n, p in named.items()}
    state = dict(zip(step._p_names, step.opt_state))
    for k in ("moment1", "moment2"):
        out[k] = {n: st[k].cpu() for n, st in state.items()}
    return losses, out


def worst_rel(a, b):
    """(max over tensors of max|a - b| / max|b|, that tensor's name)."""
    return max((float((a[n] - t).abs().max())
                / max(float(t.abs().max()), 1e-30), n) for n, t in b.items())


def train_f32_phase(torch, dev, seed):
    """2-layer Llama-2-7B-width f32 model, the same weights on the card
    (kernels) and the CPU (plain versions): 3 TrainSteps of AdamW (lr
    1e-5, eps 1e-6, wd 0.1, global-norm clip 1.0) on one 1 x 128 batch.
    Every step's loss within rtol 1e-4; the step-1 gradients, the weight
    change over the 3 steps and both moments within ``F32_TRAIN_TOL`` of
    each tensor's largest CPU value."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    gpu = LlamaForCausalLM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.randint(0, cfg.vocab_size, (1, 128),
                        generator=torch.Generator().manual_seed(seed + 3))
    l_gpu, s_gpu = f32_train_run(torch, gpu, ids, F32_TRAIN_LR,
                                 F32_TRAIN_EPS)
    l_cpu, s_cpu = f32_train_run(torch, cpu, ids, F32_TRAIN_LR,
                                 F32_TRAIN_EPS)
    worst = {k: worst_rel(s_gpu[k], s_cpu[k]) for k in F32_TRAIN_TOL}
    log(f"f32 2-layer full-width training, card vs CPU: losses "
        f"{l_gpu} vs {l_cpu}; worst max|card - cpu| / max|cpu| per "
        "tensor: " + ", ".join(f"{k} {e:.3e} ({n})"
                               for k, (e, n) in worst.items()))
    for i, (a, b) in enumerate(zip(l_gpu, l_cpu)):
        check(abs(a - b) <= 1e-4 * abs(b),
              f"step {i + 1} loss {a} on the card vs {b} on the CPU")
    for k, (e, n) in worst.items():
        check(e <= F32_TRAIN_TOL[k], f"{k} of {n} differs by {e:.3e} of "
              f"its largest value (limit {F32_TRAIN_TOL[k]})")


def _fixed_batch_iter(torch, batch, stamps):
    """data_iter_fn for one fixed batch; stamps each step's start (after
    a synchronize) so step times can be read back."""
    def data_iter_fn(start_step):
        def gen():
            while True:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                yield batch, batch
        return gen()
    return data_iter_fn


def train_phase(torch, dev, seed, card, layers, out_dir):
    """bf16 pretraining at Llama-2-7B widths (``layers`` of 32) through
    ``Trainer``: 6 steps at batch 2 x 2048 on one fixed batch, AdamW (lr
    3e-4 through CosineAnnealingDecay, wd 0.1, f32 master weights). Every
    loss finite, the last below the first, each kernel launched its
    per-layer count every step. Returns the run's launch counts."""
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay
    from paddle_tpu_torch.trainer import Trainer, TrainingArguments
    steps, b, s = 6, 2, 2048
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers, dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    crit = LlamaPretrainingCriterion(cfg)
    opt = _adamw(model, CosineAnnealingDecay(3e-4, T_max=steps))
    ids = torch.randint(0, cfg.vocab_size, (b, s),
                        generator=torch.Generator().manual_seed(seed + 4))
    stamps = []
    trainer = Trainer(
        model, opt, lambda lg, lb: crit(lg, lb),
        TrainingArguments(output_dir=out_dir, max_steps=steps,
                          logging_steps=1, save_steps=steps + 1, bf16=True),
        _fixed_batch_iter(torch, ids, stamps), tokens_per_batch=b * s)
    torch.cuda.synchronize()
    log(f"train: Llama-2-7B widths, {layers} of 32 layers, bf16, "
        f"{n_params / 1e9:.3f} B parameters, random weights (seed {seed}) "
        f"built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    res = trainer.train()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [r["loss"] for r in res["logs"]]
    step_s = [b_ - a for a, b_ in zip(stamps, stamps[1:])]
    med = statistics.median(step_s[1:])
    tok_s = b * s / med
    log(f"train: losses {losses}; step times (s) "
        f"{[round(t, 4) for t in step_s]}; launches {counts}")
    log(f"train on {card}: step median (steps 2-{steps}) {med * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {6 * n_params * tok_s / 989e12:.4f} "
        f"(6 N tokens/s over 989e12); SpeedMeter {res['tokens_per_sec']:.1f} "
        f"tokens/s, MFU {res['mfu']:.4f}; peak memory {peak / 2**30:.2f} GiB")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(len(losses) == steps and losses[-1] < losses[0],
          f"the loss does not descend: {losses}")
    want = {k: n * steps for k, n in train_kernels_per_step(layers).items()}
    check(all(counts[k] == n for k, n in want.items()),
          f"launches {counts} are not {want} ({steps} steps)")
    train_profile(torch, model, trainer, ids, card)
    return counts


def train_profile(torch, model, trainer, ids, card):
    """One more step under the profiler: device busy and idle share and
    the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._step_obj(ids, ids)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernel_ms(torch, prof)
    busy = sum(ms for ms, _ in kern.values())
    log(f"train profile on {card}: one step, wall {wall:.1f} ms (traced), "
        f"device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}")
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<6d} {name[:90]}")
    cats = {}
    for name, (ms, n) in kern.items():
        cat = next((c for c, keys in TRAIN_OP_CATEGORIES
                    if any(k in name for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    log("train profile by category: " + ", ".join(
        f"{c} {ms:.1f} ms ({100 * ms / busy:.1f}%)"
        for c, ms in sorted(cats.items(), key=lambda kv: -kv[1])))


# device kernels of a training step by kind, matched on the kernel name
TRAIN_OP_CATEGORIES = (
    ("fused_optimizer", ("fused_update_kernel", "grad_sq_", "bump_steps")),
    ("flash_bwd", ("flash_bwd",)), ("flash_fwd", ("flash_fwd",)),
    ("rms_norm", ("_rms_norm_fwd",)), ("layer_norm", ("_layer_norm_fwd",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "splitKreduce")),
    ("elementwise", ("elementwise", "copy_kernel", "CatArray", "fill")),
    ("reduce", ("reduce", "softmax", "Softmax")))


def resume_phase(torch, dev, seed, out_dir):
    """Checkpoint and resume on the card: a 2-layer bf16 model (hidden
    1024, 8 heads of 128, intermediate 2816, vocab 32000) trains 6 steps
    at batch 2 x 256 with a save at step 4; a fresh Trainer (other
    weights, fresh optimizer) resumes from it and must reach the same
    step-5 and step-6 losses, and bitwise the same step-6 weights and
    optimizer state."""
    import numpy as np
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.trainer import Trainer, TrainingArguments
    cfg = LlamaConfig(hidden_size=1024, num_attention_heads=8,
                      num_key_value_heads=8, intermediate_size=2816,
                      num_hidden_layers=2, dtype="bfloat16")
    crit = LlamaPretrainingCriterion(cfg)

    def data_iter_fn(start_step):
        def gen():
            step = start_step
            while True:
                rs = np.random.RandomState(step)
                t = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                (2, 256)).astype(np.int64))
                yield t, t
                step += 1
        return gen()

    def trainer(model_seed, save_steps):
        model = LlamaForCausalLM(cfg, device=dev).init_weights(
            torch.Generator(device=dev).manual_seed(model_seed))
        return Trainer(model, _adamw(model, 3e-4), lambda lg, lb: crit(lg, lb),
                       TrainingArguments(output_dir=out_dir, max_steps=6,
                                         logging_steps=1,
                                         save_steps=save_steps, bf16=True),
                       data_iter_fn)
    t0 = time.perf_counter()
    t_full = trainer(seed, 4)
    full = t_full.train()
    ckpt = os.path.join(out_dir, "checkpoints", "4")
    size = sum(os.path.getsize(os.path.join(ckpt, f))
               for f in os.listdir(ckpt))
    t_res = trainer(seed + 1, 100)
    res = t_res.train()
    a = [r["loss"] for r in full["logs"]]
    b_ = [r["loss"] for r in res["logs"]]
    # the losses are bf16 scalars (an ulp is 0.0625 at 10): the weights,
    # master weights and moments after step 6 are compared too
    pairs = [(x.detach(), y.detach()) for x, y in zip(
        t_full.model.parameters(), t_res.model.parameters())]
    pairs += [(x[k], y[k]) for x, y in zip(t_full._step_obj.opt_state,
                                           t_res._step_obj.opt_state)
              for k in x]
    diff = max(float((x.float() - y.float()).abs().max()) for x, y in pairs)
    log(f"resume: uninterrupted losses {a}; resumed from step "
        f"{res['start_step']} ({size / 2**30:.2f} GiB checkpoint): {b_}; "
        f"step-6 weights and optimizer state, {len(pairs)} tensors, max "
        f"abs difference {diff:.3e}; {time.perf_counter() - t0:.1f} s")
    check(res["start_step"] == 4, f"resumed at {res['start_step']}, not 4")
    check(b_ == a[4:], f"resumed losses {b_} differ from {a[4:]}")
    check(all(torch.equal(x, y) for x, y in pairs),
          f"resumed step-6 state differs (max abs {diff:.3e})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of the served model (of 32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--aot-child", metavar="SPEC",
                    help=argparse.SUPPRESS)   # the aot phase's 2nd process
    ap.add_argument("--infer-child", metavar="SPEC",
                    help=argparse.SUPPRESS)   # the Predictor process
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    if args.aot_child:
        return aot_child(torch, torch.device("cuda", 0), args.aot_child,
                         torch.cuda.get_device_name(0))
    if args.infer_child:
        return infer_child(torch, torch.device("cuda", 0), args.infer_child)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card {card}")

    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    log(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    log("kernels vs plain versions (Llama-2-7B serving and training, "
        "BERT-base fine-tuning shapes):")
    ln = ln_phase(torch, dev, g)
    mains = {"rms_norm": rms_phase(torch, dev, g),
             "layer_norm": ln["float32"],
             "flash_fwd": flash_phase(torch, dev, g),
             **flash_bwd_phase(torch, dev, g),
             "paged_decode": paged_phase(torch, dev, g),
             "ragged_decode": ragged_phase(torch, dev, g),
             "paged_varq": varq_phase(torch, dev, g)}
    # ragged_decode at the long context (timed and held to its plain
    # version in paged_long_row) beside paged_decode on the same inputs
    long = mains["paged_decode"]["extra"]
    mains["ragged_decode"]["extra"].update(
        long_ctx=long["long_ctx"], long_ms=long["long_ragged_ms"],
        long_paged_ms=long["long_ms"], long_bound_ms=long["long_bound_ms"],
        long_max_abs_err=long["long_ragged_max_abs_err"])
    dropout_phase(torch, dev, g)
    free_card(torch)
    mains.update(optimizer_phase(torch, dev, args.seed))
    mains.update(sampling_phase(torch, dev, g))
    dtype_rows = dtype_phase(torch, dev, g)
    gpt_rows = gpt_kernel_rows(torch, dev, g)
    for name, m in [*mains.items(), ("layer_norm (bf16)", ln["bfloat16"]),
                    *((row_name(*k), m) for k, m in dtype_rows.items()),
                    *((f"{k} (GPT-2 XL)", m) for k, m in gpt_rows.items())]:
        lib = "n/a" if m["library_ms"] is None else f"{m['library_ms']:.4f}"
        t = m["t"]
        log(f"  {name} on {card}, {m['shape']}: kernel median "
            f"{t['median']:.4f} ms (CUPTI {t['cupti']:.4f} ms, back to back "
            f"{t['queue']:.4f} ms per call), bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}), plain {m['plain_ms']:.4f} ms, library "
            f"{lib} ms")
    log(f"kernel phase took {time.perf_counter() - t0:.1f} s")
    free_card(torch)

    t0 = time.perf_counter()
    f32_parity_phase(torch, dev, args.seed)
    log(f"f32 serving phase took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    gate_counts = kv_dtype_gates(torch, dev, args.seed)
    log(f"kv_dtype / f16 card-vs-CPU gates took "
        f"{time.perf_counter() - t0:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    train_f32_phase(torch, dev, args.seed)
    log(f"f32 training phase took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    bert_f32_gate(torch, dev, args.seed)
    log(f"f32 BERT-base gate took {time.perf_counter() - t0:.1f} s")
    free_card(torch)

    if args.layers != 32:
        log(f"serving {args.layers} layers instead of 32 (--layers)")
    t0 = time.perf_counter()
    serve = serve_phase(torch, dev, args.seed, args.layers, card)
    counts1, counts2, counts_s = (r["counts"] for r in serve["runs"])
    log(f"serve phase took {time.perf_counter() - t0:.1f} s")
    kv = serve_kv_run(torch, dev, serve, card)
    t0 = time.perf_counter()
    serve["front"] = frontend_phase(torch, dev, args.seed, card, serve)
    log(f"front-end phase took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    infer = infer_phase(torch, dev, args.seed, card, serve["model"])
    mains["flash_fwd"]["extra"]["decode_launches"] = \
        infer["counts"]["flash_fwd"]
    log(f"inference-API phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aot_phase(torch, dev, args.seed, args.layers, card, serve)
    del serve
    log(f"aot phase took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    t0 = time.perf_counter()
    gpt = gpt_phase(torch, dev, args.seed, card)
    log(f"gpt phase took {time.perf_counter() - t0:.1f} s")
    free_card(torch)
    f16 = serve_f16_phase(torch, dev, args.seed,
                          min(args.layers, F16_LAYERS), card)
    bert16 = bert_f16_eval(torch, dev, args.seed, card)

    t0 = time.perf_counter()
    counts_ft = finetune_run(torch, dev, card, "bert", 30)
    free_card(torch)
    finetune_run(torch, dev, card, "ernie", 6)
    log(f"fine-tune phase took {time.perf_counter() - t0:.1f} s")
    free_card(torch)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "output", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        counts3 = train_phase(torch, dev, args.seed, card, TRAIN_LAYERS,
                              os.path.join(out_dir, "run"))
        log(f"training phase took {time.perf_counter() - t0:.1f} s")
        free_card(torch)
        resume_phase(torch, dev, args.seed, os.path.join(out_dir, "resume"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    sources = {"rms_norm": ("triton",
                            "paddle_tpu_torch/kernels/_rms_triton.py",
                            "paddle_tpu/kernels/norm.py:27"),
               "layer_norm": ("triton",
                              "paddle_tpu_torch/kernels/_ln_triton.py",
                              "paddle_tpu/kernels/norm.py:98"),
               "flash_fwd": ("cuda", "paddle_tpu_torch/csrc/flash_fwd.cu",
                             "paddle_tpu/kernels/attention.py:163"),
               "flash_bwd_dkdv": ("cuda", "paddle_tpu_torch/csrc/flash_bwd.cu",
                                  "paddle_tpu/kernels/attention.py:361"),
               "flash_bwd_dq": ("cuda", "paddle_tpu_torch/csrc/flash_bwd.cu",
                                "paddle_tpu/kernels/attention.py:464"),
               "paged_decode": ("cuda",
                                "paddle_tpu_torch/csrc/paged_decode.cu",
                                "paddle_tpu/kernels/paged_attention.py:104"),
               "ragged_decode": ("cuda",
                                 "paddle_tpu_torch/csrc/ragged_decode.cu",
                                 "paddle_tpu/kernels/paged_attention.py:363"),
               "paged_varq": ("cuda", "paddle_tpu_torch/csrc/paged_varq.cu",
                              "paddle_tpu/kernels/paged_attention.py:516"),
               # no Pallas kernel: the reference leaves the fused update
               # (and the clip's norm) to XLA
               "fused_update": ("cuda",
                                "paddle_tpu_torch/csrc/fused_optimizer.cu",
                                "paddle_tpu/optimizer/fused.py:181 (XLA, "
                                "no Pallas)"),
               "grad_sq_norm": ("cuda",
                                "paddle_tpu_torch/csrc/fused_optimizer.cu",
                                "paddle_tpu/optimizer/fused.py:181 (XLA, "
                                "no Pallas)"),
               # no Pallas kernel: the reference leaves the draws to XLA
               "categorical_rows": ("cuda", "paddle_tpu_torch/csrc/sampling.cu",
                                    "paddle_tpu/generation/sampling.py:175 "
                                    "(XLA, no Pallas)"),
               "uniform64_rows": ("cuda", "paddle_tpu_torch/csrc/sampling.cu",
                                  "paddle_tpu/generation/sampling.py:199 "
                                  "(XLA, no Pallas)")}
    rows = []
    for name, (route, src, replaces) in sources.items():
        m = mains[name]
        # launches from the run that drives the kernel: the BERT-base
        # fine-tune run for LayerNorm and the flash kernels, the Llama
        # training run for rms_norm and the optimizer kernels, serve run
        # 1 (block table) for paged_decode, serve run 3 (run 2 with
        # sampling) for the draw kernels, serve run 2 (ragged, chunked,
        # speculative) for the rest
        counts = counts_ft if name in FINETUNE_KERNELS else \
            counts3 if name in TRAIN_KERNELS else \
            counts1 if name in RUN1_KERNELS else \
            counts_s if name in SAMPLING_KERNELS else counts2
        rows.append({"name": name, "route": route, "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": m["max_abs_err"],
                     "ms": m["t"]["median"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], **m.get("extra", {})})
        if name == "fused_update":
            rows[-1]["bert_launches"] = counts_ft[name]
    # the f16 and mixed instances: launches of the instance in the run that
    # drives it on the card (serve run F16, the 2-layer gates' block-table
    # f16 decode, the BERT-base f16 eval; serve run KV for bf16 q over f32
    # pages; the 2-layer f32 gate for f32 q over bf16 pages)
    for key, m in dtype_rows.items():
        route, src, replaces = sources[key[0]]
        n = next((c[key] for c in (f16["dtype_counts"], gate_counts, bert16,
                                   kv["dtype_counts"]) if c.get(key)), 0)
        check(n > 0, f"{row_name(*key)} was launched on no served path")
        rows.append({"name": row_name(*key), "route": route, "source": src,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": m["max_abs_err"],
                     "ms": m["t"]["median"], "plain_ms": m["plain_ms"],
                     "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], "shape": m["shape"],
                     **m.get("extra", {})})
    # GPT-2 XL's LayerNorm width and static-decode flash shape: launches
    # in the GPT phase's greedy and beam runs
    for name, run in (("layer_norm", "greedy"), ("flash_fwd", "beam")):
        m = gpt_rows[name]
        route, src, replaces = sources[name]
        rows.append({"name": f"{name} (bfloat16, GPT-2 XL)", "route": route,
                     "source": src, "replaces": replaces,
                     "launches": gpt[run]["counts"][name],
                     "max_abs_err": m["max_abs_err"], "ms": m["t"]["median"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"], "shape": m["shape"],
                     "cupti_ms": m["t"]["cupti"],
                     "queue_ms": m["t"]["queue"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
