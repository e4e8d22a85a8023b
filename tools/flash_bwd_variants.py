#!/usr/bin/env python3
"""Design variants of the port's bf16 flash-attention backward kernels
(``paddle_tpu_torch/csrc/flash_bwd.cu``), built side by side on one GPU.

    python3 tools/flash_bwd_variants.py [--iters 20]

Each variant is the shipped source with one design choice undone:

- ``shipped``: as committed.
- ``single_bf16``: P and dS enter the accumulating products as one bf16
  each, without the lo part (dK/dV 4 products per tile pair, dQ 3).
- ``two_warpgroups``: a dK/dV CTA of two warpgroups (128 keys) sharing
  each Q / dO tile, one CTA per SM.
- ``no_prefetch``: no copy of the next tile starts during a tile's
  products (stale tiles after the first: timing only).

Every variant is compiled with the same nvcc flags as the package and
called through the same C entries. Prints, per variant, the largest
error against ``flash_attention_bwd_plain`` with the card tolerance's
verdict (atol 5e-3, rtol 2e-2) at the training shape q[2, 2048, 32, 128]
bf16 causal and at a ragged causal GQA case, q[1, 136, 4, 64] with 2 KV
heads, and the median device time of each kernel at the training shape.
Needs one CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TOL = dict(atol=5e-3, rtol=2e-2)


def variants(src):
    """{name: source}; raises if a pattern no longer matches the source."""
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"pattern not in flash_bwd.cu: {old!r}")
        return text.replace(old, new)
    single = src
    for line in ("      wgmma_rs_tb(dv_acc, pl[kk], mnmajor_desc<kBM>(os, kk));\n",
                 "      wgmma_rs_tb(dk_acc, sl[kk], mnmajor_desc<kBM>(qs, kk));\n",
                 "      wgmma_rs_tb(acc, sl[kk], mnmajor_desc<BN>(ks, kk));\n"):
        single = sub(single, line, "")
    return {
        "shipped": src,
        "single_bf16": single,
        "two_warpgroups": sub(src, "constexpr int kDkdvWG = 1;",
                              "constexpr int kDkdvWG = 2;"),
        "no_prefetch": sub(src, "    if (it + 1 < n_it) load_stage(it + 1, st ^ 1);",
                           "    if (it + 1 < n_it && it == 0) "
                           "load_stage(it + 1, st ^ 1);"),
    }


def build(sources, out_dir):
    """Compile every variant in parallel; returns {name: ctypes library}."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.attention import _BWD_SIGNATURES
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             str(_build.SRC_DIR), "-o", os.path.join(out_dir, f"{name}.so"),
             cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, argtypes in _BWD_SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(argtypes), ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import attention as A
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(os.path.join(REPO, "paddle_tpu_torch", "csrc",
                           "flash_bwd.cu")) as f:
        sources = variants(f.read())
    tmp = tempfile.mkdtemp(prefix="flash_bwd_variants_")
    libs = build(sources, tmp)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def case(b, s, h, hkv, d):
        q, do = (torch.randn(b, s, h, d, device=dev, generator=g).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, s, hkv, d, device=dev, generator=g).bfloat16()
                for _ in range(2))
        out, lse = A.flash_attention_kernel(q, k, v, d ** -0.5, True)
        want = A.flash_attention_bwd_plain(q, k, v, out, lse, do, d ** -0.5,
                                           True)
        delta = A.bwd_delta(out, do)
        head, dims = A._bwd_args("variants", q, k, v, do, lse, delta, None,
                                 None)
        outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        tail = (float(d ** -0.5), 1, 0, 0, 0, 0.0, A.stream_ptr(dev))
        # the C entries take raw pointers: the inputs stay referenced here
        return head, dims, tail, outs, want, (q, k, v, do, lse, delta)

    cases = {"q[2, 2048, 32, 128]": case(2, 2048, 32, 32, 128),
             "q[1, 136, 4, 64] Hkv=2": case(1, 136, 4, 2, 64)}

    def launch(lib, c, which):
        head, dims, tail, (dq, dk, dv) = c[:4]
        if which == "dkdv":
            err = lib.flash_bwd_dkdv(*head, dk.data_ptr(), dv.data_ptr(),
                                     *dims, *tail)
        else:
            err = lib.flash_bwd_dq(*head, dq.data_ptr(), *dims, *tail)
        if err:
            raise RuntimeError(f"{which}: CUDA error {err} at launch")

    def median_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(args.iters):
            torch.cuda._sleep(1_000_000)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    for name, lib in libs.items():
        notes = []
        for label, c in cases.items():
            if name == "no_prefetch":
                break
            launch(lib, c, "dkdv")
            launch(lib, c, "dq")
            torch.cuda.synchronize()
            for w, got, ref in zip(("dq", "dk", "dv"), c[3], c[4]):
                got, ref = got.float(), ref.float()
                err = float((got - ref).abs().max())
                bad = int((~torch.isclose(got, ref, **TOL)).sum())
                notes.append(f"{label} {w} max abs err {err:.3e}, "
                             f"{bad} outside tolerance")
        train = cases["q[2, 2048, 32, 128]"]
        t = [median_ms(lambda: launch(lib, train, w)) for w in ("dkdv", "dq")]
        print(f"{name}: dkdv {t[0]:.4f} ms, dq {t[1]:.4f} ms at "
              f"q[2, 2048, 32, 128] bf16 causal", flush=True)
        for n in notes:
            print(f"  {n}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
