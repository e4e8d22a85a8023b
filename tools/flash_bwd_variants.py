#!/usr/bin/env python3
"""Design variants of the port's flash-attention backward kernels
(``paddle_tpu_torch/csrc/flash_bwd.cu``), built side by side on one GPU.

    python3 tools/flash_bwd_variants.py [--iters 24] [--parent DIR]
                                        [--only NAME,...]

Each variant is the shipped source with one design choice undone, or
another checkout's:

- ``shipped``: as committed.
- ``parent``: the ``flash_bwd.cu`` of ``--parent DIR`` (a ``git archive``
  of another commit unpacked anywhere), built against that checkout's
  headers.
- ``single_bf16``: P and dS enter the accumulating products as one bf16
  each, without the lo part (16-bit dK/dV 4 products per tile pair, dQ
  3; f32 14 and 12).
- ``two_warpgroups``: a dK/dV CTA of two warpgroups (128 keys) sharing
  each Q / dO tile, one CTA per SM; at BERT-base's 128 keys one CTA per
  (batch, head) walking every key (f32 at head_dim 128 does not fit and
  is reported as refused).
- ``f32_no_split`` (diagnostic: wrong outputs by design, its time shows
  what the split costs): the f32 instances never split the streamed f32
  tiles (Q and dO in dK/dV, K and V in dQ) into their part tiles.

Timed cases (``chip_smoke.time_ms``: median of CUDA events around each
call, inputs rotating past the 50 MB L2, with the CUPTI and back-to-back
times): f32 at BERT-base's fine-tune shape q[16, 128, 12, 64] with a key
mask (half the rows padded past key 96, as ``tools/kernel_times.py``),
also with dropout 0.1; bf16 and f16 at the training shape q[2, 2048, 32,
128] causal. Beside them, once: f32 SDPA's backward on the BERT inputs
(dQ, dK and dV together), the plain backward there, and causal SDPA's
bf16 backward at the training shape (``chip_smoke.sdpa_bwd_times``; the
bounds are ``tools/kernel_times.py``'s). Each variant's largest error against
``flash_attention_bwd_plain`` with ``chip_smoke.TOL``'s verdict, at the
timed cases and at f32 q[2, 2048, 32, 128] causal and a ragged causal GQA
case q[1, 136, 4, 64] with 2 KV heads (f32 and bf16). Needs one CUDA
device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEEDS = (-1234567891, 987654321)


def variants(src):
    """{name: source}; raises if a pattern no longer matches the source."""
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"pattern not in flash_bwd.cu: {old!r}")
        return text.replace(old, new)
    single = src
    for line in ("      wgmma_rs_tb(dv_acc, pl[kk], mnmajor_desc<kBM>(os, kk));\n",
                 "      wgmma_rs_tb(dk_acc, sl[kk], mnmajor_desc<kBM>(qs, kk));\n",
                 "        wgmma_rs_tb(dk_acc, sl[kk], mnmajor_desc<kBM>(qs + Q_BYTES, kk));\n",
                 "      wgmma_rs_tb(acc, sl[kk], mnmajor_desc<BN>(ks, kk));\n",
                 "        wgmma_rs_tb(acc, sl[kk], mnmajor_desc<BN>(ks + T_BYTES, kk));\n"):
        single = sub(single, line, "")
    no_split = src
    for line in ("      split_tile<kBM, D, NT, 3>(qs, qs + Q_BYTES, sF, tid, qs + 2 * Q_BYTES);\n",
                 "      split_tile<kBM, D, NT, 3>(os, os + Q_BYTES, sF, tid, os + 2 * Q_BYTES);\n",
                 "      split_tile<BN, D, NT, 3>(ks, ks + T_BYTES, sF, tid, ks + 2 * T_BYTES);\n",
                 "      split_tile<BN, D, NT, 3>(vs, vs + T_BYTES, sF, tid, vs + 2 * T_BYTES);\n"):
        no_split = sub(no_split, line, "")
    return {
        "shipped": src,
        "single_bf16": single,
        "two_warpgroups": sub(src, "constexpr int kDkdvWG = 1;",
                              "constexpr int kDkdvWG = 2;"),
        "f32_no_split": no_split,
    }


def build(sources, out_dir):
    """Compile every variant in parallel; returns {name: ctypes library}.
    ``sources`` maps a name to (source text, include directory)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.attention import _BWD_SIGNATURES
    procs = {}
    for name, (text, inc) in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", inc,
             "-o", os.path.join(out_dir, f"{name}.so"), cu],
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
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--only", help="comma-separated variant names")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attention as A
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    with open(_build.SRC_DIR / "flash_bwd.cu") as f:
        sources = {n: (t, str(_build.SRC_DIR))
                   for n, t in variants(f.read()).items()}
    if args.parent:
        csrc = os.path.join(os.path.abspath(args.parent), "paddle_tpu_torch",
                            "csrc")
        with open(os.path.join(csrc, "flash_bwd.cu")) as f:
            sources["parent"] = (f.read(), csrc)
    if args.only:
        keep = set(args.only.split(","))
        sources = {n: s for n, s in sources.items() if n in keep}
    libs = build(sources, tempfile.mkdtemp(prefix="flash_bwd_variants_"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dt):
        return torch.randn(*shape, device=dev, generator=g).to(dt)

    def inputs(dt, b, s, h, hkv, d, causal, mask=None, p=0.0):
        """One input set: (q, k, v, dO, out, lse, delta)."""
        q, do = rnd((b, s, h, d), dt), rnd((b, s, h, d), dt)
        k, v = rnd((b, s, hkv, d), dt), rnd((b, s, hkv, d), dt)
        out, lse = A.flash_attention_kernel(
            q, k, v, d ** -0.5, causal, mask, dropout_p=p,
            seeds=SEEDS if p else None)
        return q, k, v, do, out, lse, A.bwd_delta(out, do)

    key = S.bert_key_mask(torch, dev)
    # name: (dtype, B, S, H, Hkv, D, causal, mask, dropout p, input sets)
    cases = {
        "f32 q[16, 128, 12, 64] key mask":
            ("float32", 16, 128, 12, 12, 64, False, key, 0.0, 4),
        "f32 q[16, 128, 12, 64] key mask, dropout 0.1":
            ("float32", 16, 128, 12, 12, 64, False, key, 0.1, 4),
        "bf16 q[2, 2048, 32, 128] causal":
            ("bfloat16", 2, 2048, 32, 32, 128, True, None, 0.0, 2),
        "f16 q[2, 2048, 32, 128] causal":
            ("float16", 2, 2048, 32, 32, 128, True, None, 0.0, 2),
        "f32 q[2, 2048, 32, 128] causal":
            ("float32", 2, 2048, 32, 32, 128, True, None, 0.0, 1),
        "f32 q[1, 136, 4, 64] Hkv=2 causal":
            ("float32", 1, 136, 4, 2, 64, True, None, 0.0, 1),
        "bf16 q[1, 136, 4, 64] Hkv=2 causal":
            ("bfloat16", 1, 136, 4, 2, 64, True, None, 0.0, 1),
    }
    timed = list(cases)[:4]
    data, want = {}, {}
    for name, (dt, b, s, h, hkv, d, causal, mask, p, n) in cases.items():
        sets = [inputs(getattr(torch, dt), b, s, h, hkv, d, causal, mask, p)
                for _ in range(n)]
        q, k, v, do, out, lse, _ = sets[0]
        drop = dict(dropout_p=p, seeds=SEEDS if p else None)
        want[name] = A.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                 d ** -0.5, causal, mask,
                                                 **drop)
        data[name] = sets

    def launcher(lib, name, which):
        dt, b, s, h, hkv, d, causal, mask, p = cases[name][:9]
        tail = (float(d ** -0.5), int(causal),
                *A._dropout_args(p, A.seed_slot(p, SEEDS, dev)),
                A.stream_ptr(dev))

        def run(q, k, v, do, out, lse, delta):
            head, dims = A._bwd_args("variants", q, k, v, do, lse, delta,
                                     mask, None)
            if which == "dkdv":
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                err = lib.flash_bwd_dkdv(*head, dk.data_ptr(), dv.data_ptr(),
                                         *dims, *tail)
                res = (dk, dv)
            else:
                dq = torch.empty_like(q)
                err = lib.flash_bwd_dq(*head, dq.data_ptr(), *dims, *tail)
                res = (dq,)
            if err:
                raise RuntimeError(f"{which}: CUDA error {err} at launch")
            return res
        return run

    def fmt(t):
        return f"{t['median']:.4f} ms (CUPTI {t['cupti']:.4f}; back to " \
               f"back {t['queue']:.4f})"

    results = {}
    for vname, lib in libs.items():
        refused = set()
        for name in cases:
            dt = cases[name][0]
            try:
                dq, = launcher(lib, name, "dq")(*data[name][0])
                dk, dv = launcher(lib, name, "dkdv")(*data[name][0])
            except RuntimeError as e:       # e.g. too much shared memory
                print(f"{vname}: {name}: refused ({e})", flush=True)
                refused.add(name)
                continue
            torch.cuda.synchronize()
            errs = []
            for w, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                   want[name]):
                got, ref = got.float(), ref.float()
                bad = int((~torch.isclose(got, ref, **S.TOL[dt])).sum())
                errs.append(f"{w} {float((got - ref).abs().max()):.3e}"
                            f"{'' if not bad else f' ({bad} outside)'}")
            print(f"{vname}: {name}: max abs err " + ", ".join(errs),
                  flush=True)
        for name in (n for n in timed if n not in refused):
            t = {w: S.time_ms(torch, launcher(lib, name, w), data[name],
                              iters=args.iters) for w in ("dkdv", "dq")}
            results[f"{vname} | {name}"] = {
                w: {k: round(x, 5) for k, x in t[w].items()} for w in t}
            print(f"{vname}: {name}: dkdv {fmt(t['dkdv'])}, dq "
                  f"{fmt(t['dq'])}", flush=True)

    # yardsticks on the same inputs: one PyTorch call of the same function
    # (SDPA's backward: dQ, dK and dV together) and the plain backward
    for name in timed[:1] + timed[2:3]:
        dt, b, s, h, hkv, d, causal, mask, p = cases[name][:9]
        lib_t = S.sdpa_bwd_times(torch, data[name], mask, causal,
                                 iters=args.iters)
        print(f"SDPA backward {name} (dQ, dK, dV): {fmt(lib_t)}",
              flush=True)
        results[f"sdpa backward | {name}"] = lib_t
        if dt == "float32":
            plain = S.time_ms(torch, lambda q, k, v, do, out, lse, _:
                              A.flash_attention_bwd_plain(
                                  q, k, v, out, lse, do, d ** -0.5, causal,
                                  mask), data[name], iters=args.iters)
            print(f"plain backward {name} (dQ, dK, dV): {fmt(plain)}",
                  flush=True)
            results[f"plain backward | {name}"] = plain
    print(json.dumps({"card": smi, "times": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
