#!/usr/bin/env python3
"""Design variants of the port's bf16 flash-attention forward
(``paddle_tpu_torch/csrc/flash_fwd.cu``) and bf16 paged decode
(``paddle_tpu_torch/csrc/paged_decode.cu``), built side by side on one GPU.

    python3 tools/kernel_variants.py [--iters 24]

Each variant is the shipped source with one choice changed:

- ``flash_fwd wgW_bnN``: W warpgroups (64 query rows each) per CTA and
  key tiles of N keys (``kFwdWG``, ``kFwdBN``), W in {1, 2}, N in
  {64, 128}; ``wg1_bn64`` is the shipped choice. ``wg1_bn64_3stages``:
  3-stage K/V rings (``kFwdStages``), two tiles of copies ahead.
  ``wg1_bn64_single_bf16_p``: P enters P V as one bf16 (``kFwdSplitP``
  off) instead of bf16 hi + lo parts. ``wg1_bn64_l2_mask``: the mask read
  from L2 into registers in the accumulator layout where the shipped
  kernel stages it through shared memory by cp.async.
- ``paged_decode clusterC``: each (sequence, KV head) walk split over at
  most C CTAs (``kMaxCluster``), C in {1, 2, 4, 8}; 1 is one CTA walking
  the whole context, as before the split; 4 is shipped.
  ``cluster4_chunk64``: 64-token ring stages (``kSplitChunk``) instead of
  32.

Every variant is compiled with the same nvcc flags as the package and
called through the same C entries. Prints, per variant, the largest
error against the plain version with the card tolerance's verdict (atol
5e-3, rtol 2e-2), and the median device time (``chip_smoke.time_ms``:
events around each call, inputs rotating past the 50 MB L2) at the
shapes of ``chip_smoke.py``: flash at q[4, 512, 32, 128] causal + a
prefill mask and at the training shape q[2, 2048, 32, 128] causal (its
error over four input draws, with the first elements outside the
tolerance); paged decode at q[4, 32, 128] with contexts 557 / 300 / 97 /
1 and at a long context of 1024 / 1000 / 700 / 333 (page 16, 64 pages
per sequence). Beside them: each flash variant at the first shape
without its mask (what the mask costs), SDPA at both flash shapes, and ``ragged_decode`` on the paged
inputs. Needs one CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TOL = dict(atol=5e-3, rtol=2e-2)
NEG = -1e30


def variants(path, consts):
    """{name: source} of the file with each listed constant set; raises
    if a constant's shipped line is no longer in the source."""
    with open(path) as f:
        src = f.read()
    out = {}
    for name, subs in consts.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"pattern not in {path}: {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources, out_dir, signatures):
    """Compile every variant in parallel; returns {name: ctypes library}."""
    from paddle_tpu_torch.kernels import _build
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
             str(_build.SRC_DIR), "-o", os.path.join(out_dir, f"{name}.so"),
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed, skipped:\n{out}", flush=True)
            continue
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(argtypes), ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=24)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.kernels import paged_attention as P
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    csrc = os.path.join(REPO, "paddle_tpu_torch", "csrc")
    wg, bn = "constexpr int kFwdWG = 1;", "constexpr int kFwdBN = 64;"
    st = "constexpr int kFwdStages = 2;"
    fwd_consts = {f"wg{w}_bn{n}": [(wg, f"constexpr int kFwdWG = {w};"),
                                   (bn, f"constexpr int kFwdBN = {n};")]
                  for w in (1, 2) for n in (64, 128)}
    fwd_consts["wg1_bn64_3stages"] = [(st, "constexpr int kFwdStages = 3;")]
    fwd_consts["wg1_bn64_single_bf16_p"] = [(
        "constexpr bool kFwdSplitP = true;",
        "constexpr bool kFwdSplitP = false;")]
    fwd_consts["wg1_bn64_l2_mask"] = [(
        "  const int stage = kFwdWG == 1 && mask",
        "  const int stage = false && mask")]
    fwd_src = variants(os.path.join(csrc, "flash_fwd.cu"), fwd_consts)
    cl = "constexpr int kMaxCluster = 4;"
    paged_consts = {f"cluster{c}": [(cl, f"constexpr int kMaxCluster = {c};")]
                    for c in (1, 2, 4, 8)}
    paged_consts["cluster4_chunk64"] = [("constexpr int kSplitChunk = 32;",
                                         "constexpr int kSplitChunk = 64;")]
    paged_src = variants(os.path.join(csrc, "paged_decode.cu"), paged_consts)
    tmp = tempfile.mkdtemp(prefix="kernel_variants_")
    fwd_libs = build(fwd_src, tmp, A._SIGNATURES)
    paged_libs = build(paged_src, tmp, P._SIGNATURES["paged_decode"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def med(fn, sets):
        return S.time_ms(torch, fn, sets, iters=args.iters)["median"]

    def verdict(got, want, rows=None):
        """Largest error and the count outside tolerance, with the index,
        value and reference of the first few elements outside it."""
        got, want = got.float(), want.float()
        if rows is not None:
            got, want = got[rows], want[rows]
        bad = ~torch.isclose(got, want, **TOL)
        where = [(tuple(i.tolist()), round(float(got[tuple(i)]), 5),
                  round(float(want[tuple(i)]), 5))
                 for i in bad.nonzero()[:4]]
        return f"max abs err {float((got - want).abs().max()):.3e}, " \
               f"{int(bad.sum())} outside tolerance {where or ''}"

    # ------------------------------------------------------ flash_fwd --
    def fwd(lib, q, k, v, mask, causal):
        b, sq, h, d = q.shape
        m_ptr, *strides = A._mask_args(mask, k.shape[1])
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        err = lib.flash_fwd(1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            m_ptr, None, out.data_ptr(), lse.data_ptr(), b,
                            sq, k.shape[1], h, k.shape[2], *strides,
                            float(d ** -0.5), int(causal), 0, 0, 0, 0.0,
                            A.stream_ptr(dev))
        if err:
            raise RuntimeError(f"flash_fwd: CUDA error {err} at launch")
        return out

    def qkv(b, s, h):
        return [tuple(torch.randn(b, s, h, 128, device=dev,
                                  generator=g).bfloat16() for _ in range(3))
                for _ in range(2)]

    lens = torch.tensor([512, 384, 200, 64], device=dev)
    mask, key_valid = S.prefill_mask(torch, dev, lens, 512)
    serve, train = qkv(4, 512, 32), qkv(2, 2048, 32)
    want_s = A.flash_attention_plain(*serve[0], 128 ** -0.5, True, mask)
    # the training shape's error over four draws (rare outliers show)
    draws = train + qkv(2, 2048, 32)
    want_t = [A.flash_attention_plain(*d, 128 ** -0.5, True) for d in draws]
    F = torch.nn.functional
    causal = torch.tril(torch.ones(512, 512, dtype=torch.bool, device=dev))
    full = (mask + torch.where(causal, 0.0, NEG)).bfloat16()

    def sdpa(a, b, c, m=None):
        return F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            attn_mask=m, is_causal=m is None, scale=128 ** -0.5)
    print(f"SDPA: q[4, 512, 32, 128] causal + mask "
          f"{med(lambda a, b, c: sdpa(a, b, c, full), serve):.4f} ms, "
          f"q[2, 2048, 32, 128] causal {med(sdpa, train):.4f} ms",
          flush=True)
    for name, lib in fwd_libs.items():
        t_s = med(lambda a, b, c: fwd(lib, a, b, c, mask, True), serve)
        t_t = med(lambda a, b, c: fwd(lib, a, b, c, None, True), train)
        t_n = med(lambda a, b, c: fwd(lib, a, b, c, None, True), serve)
        print(f"flash_fwd {name}: q[4, 512, 32, 128] causal + mask "
              f"{t_s:.4f} ms (no mask {t_n:.4f}), q[2, 2048, 32, 128] "
              f"causal {t_t:.4f} ms", flush=True)
        e_s = verdict(fwd(lib, *serve[0], mask, True), want_s, key_valid)
        e_t = verdict(torch.stack([fwd(lib, *d, None, True) for d in draws]),
                      torch.stack(want_t))
        print(f"  serve shape {e_s}; training shape {e_t}", flush=True)

    # --------------------------------------------------- paged_decode --
    b, d, page, pps, h, hkv = 4, 128, 16, 64, 32, 32
    num_pages = b * pps + 1
    tables = torch.randperm(num_pages, device=dev, generator=g)[
        :b * pps].reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn(b, h, d, device=dev, generator=g).bfloat16()
    sets = [tuple(torch.randn(num_pages, page, hkv, d, device=dev,
                              generator=g).bfloat16() for _ in range(2))
            for _ in range(4)]

    def paged(lib, kp, vp, ctx):
        out = torch.empty_like(q)
        err = lib.paged_decode(1, d, q.data_ptr(), kp.data_ptr(),
                               vp.data_ptr(), tables.data_ptr(),
                               ctx.data_ptr(), out.data_ptr(), b, h, hkv,
                               page, pps, num_pages, d ** -0.5,
                               A.stream_ptr(dev))
        if err:
            raise RuntimeError(f"paged_decode: CUDA error {err} at launch")
        return out

    for ctx_list in ([557, 300, 97, 1], [1024, 1000, 700, 333]):
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
        want = P.paged_attention_plain(q, *sets[0], tables, ctx, d ** -0.5)
        meta = S._builder_meta(torch, dev, tables, ctx, page)
        t_r = med(lambda kp, vp: P.paged_attention_ragged_kernel(
            q, kp, vp, ctx, meta, d ** -0.5), sets)
        print(f"ragged_decode at ctx {ctx_list}: {t_r:.4f} ms", flush=True)
        for name, lib in paged_libs.items():
            t = med(lambda kp, vp: paged(lib, kp, vp, ctx), sets)
            print(f"paged_decode {name} ctx {ctx_list}: {t:.4f} ms; "
                  f"{verdict(paged(lib, *sets[0], ctx), want)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
