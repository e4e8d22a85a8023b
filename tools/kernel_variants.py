#!/usr/bin/env python3
"""Design variants of the port's bf16 attention kernels, built side by
side on one GPU: the flash-attention forward (``csrc/flash_fwd.cu``;
its one-row decode route runs the cluster-split walk of
``csrc/decode_split.cuh``; its instance for a 16-bit q over f32 K/V),
paged decode (``csrc/paged_decode.cu``), ragged decode
(``csrc/ragged_decode.cu``; both decode kernels run the same walk) and
the variable-query span kernel (``csrc/paged_varq.cu``); and the f32
forward on the tensor cores (route ``wgmma_f32``).

    python3 tools/kernel_variants.py [--iters 24] [--only NAME,...]
                                     [--parent DIR] [--dtype float16]
                                     [--kv float32]

``--only`` picks sections (flash_fwd, flash_decode, flash_f32kv,
flash_f32, paged_decode, ragged_decode, paged_varq; default all). ``--parent`` names a checkout
of another commit (``git archive`` of it unpacked anywhere): its kernels
of every section but flash_fwd are built and timed beside these as
``parent`` (a parent whose C entries take one dtype code is called with
one). ``--dtype`` runs every section on that 16-bit dtype's inputs
(default bfloat16), held to its tolerance (``chip_smoke.TOL``); ``--kv
float32`` gives the decode sections and the span kernel f32 pages under
those queries (a 16-bit model over an f32 KV pool). Each variant is the
shipped source with one choice changed:

- ``flash_fwd wgW_bnN``: W warpgroups (64 query rows each) per CTA and
  key tiles of N keys (``kFwdWG``, ``kFwdBN``), W in {1, 2}, N in
  {64, 128}; ``wg1_bn64`` is the shipped choice. ``wg1_bn64_3stages``:
  3-stage K/V rings (``kFwdStages``), two tiles of copies ahead.
  ``wg1_bn64_single_bf16_p``: P enters P V as one bf16 (``kFwdSplitP``
  off) instead of bf16 hi + lo parts; ``wg1_bn64_split_f16_p`` the
  other way for the f16 instance, which ships one f16 P: f16 hi + lo
  parts (``kFwdSplitPF16`` on; read with ``--dtype float16``).
  ``wg1_bn64_l2_mask``: the mask read from L2 into registers in the
  accumulator layout where the shipped kernel stages it through shared
  memory by cp.async.
- ``flash_decode``: the forward at one query row (the static route's
  decode steps), through the one-row decode route. ``clusterC``: each
  (sequence, KV head) walk split over at most C CTAs (``kMaxCluster``),
  C in {1, 2, 8} (4 is shipped); ``slotsN``: the ranks cut back to keep
  a launch within N CTAs (``kSplitSlots``, 1024 shipped), N in {512,
  2048}; ``stage2048`` and ``stage8192``: ring stages of 2 or 8 KiB of K
  rows (``kDenseStageBytes``; 4 KiB shipped: 16 keys at head_dim 128,
  32 at 64); ``stages3`` and ``stages4``: rings of 3 or 4 stages
  (``kDenseStages``; 2 shipped); ``all_keys``: every key below kv_lens
  walked, the masked ones scored -1e30, where the shipped walk finds the
  window of kept keys first (``kDenseWindow``). Timed at Llama-2-7B's static
  decode shape q[8, 1, 32, 128] against 544 keys and GPT-2 XL's beam and
  greedy shapes q[16, 1, 25, 64] and q[4, 1, 25, 64] against 332 (the
  route's bool padding mask, ``chip_smoke.static_decode_case``), beside
  SDPA with the same mask and the bytes bound; ``parent`` is the
  parent's forward at the same shapes (before the decode route: the
  64-row ``wgmma`` tile).
- ``paged_decode clusterC`` and ``ragged_decode clusterC``: each
  (sequence, KV head) walk split over at most C CTAs (``kMaxCluster``),
  C in {1, 2, 4} (and 8 for paged decode); 1 is one CTA walking the
  whole context; 4 is shipped. ``cluster4_chunk64``: 64-key ring stages
  (``kSplitChunk``) instead of 32. With ``--kv float32`` (the ring's
  f32 instance): ``f32_chunk32`` (``kSplitChunkF32`` 32 keys a stage
  instead of 16), ``f32_stages2`` and ``f32_stages4``
  (``kSplitStagesF32``; 3 shipped) and ``slotsN`` as for
  ``flash_decode``.
- ``flash_f32kv``: the forward with q of ``--dtype`` over f32 K/V (the
  ``wgmma_f32kv`` instance: K and V staged as f32 rows, split into bf16
  hi + lo tiles) at the prefix cache's suffix-prefill shape, q[1, 128,
  32, 128] against 384 keys under the suffix's mask, with 32 and with 4
  KV heads; ``parent`` is the parent's instance (before this route: the
  FMA kernel). ``f32_bn32``: 32-key tiles and a 3-stage f32 ring
  (``kFwdBNF32``, ``kFwdStagesF32``; 64 keys and 2 stages shipped, where
  a bf16 q's mask is staged and an f16 q's read from L2); ``f32_bn32_stages2``:
  32-key tiles, 2 stages. Two diagnostic variants, whose outputs are
  wrong by design and whose times show what a part of the tile's work
  costs: ``f32_no_split`` (the f32 rows never split into the hi and lo
  tiles) and ``f32_no_load`` (the f32 rows never copied in).
- ``flash_f32``: the forward with q, k and v in f32 (the ``wgmma_f32``
  instance: Q, K and V staged as f32 rows, split into bf16 hi, mid and
  lo tiles; always f32, whatever ``--dtype`` says) at BERT-base's
  fine-tune shape q[16, 128, 12, 64] under ``chip_smoke.bert_key_mask``,
  without and with dropout 0.1, and at q[4, 512, 32, 128] causal + a
  prefill mask; ``parent`` is the parent's f32 forward (before this
  route: the FMA kernel), timed in the same process. ``f32_no_split``
  is the diagnostic variant of ``flash_f32kv`` (K's and V's rows never
  split; wrong by design); ``f32_l2_mask`` reads a mask
  whose rows differ from L2 where the shipped kernel stages it (the
  q[4, 512, 32, 128] case: BERT's key mask, one row for every query, is
  read from L2 by both). Beside them f32 SDPA with the same mask (and
  with dropout 0.1, another function of the same cost) and the bytes
  bound; the error is held to the f32 tolerance.
- ``paged_varq``: ``shipped`` (P as bf16 hi + lo, a 2-stage K/V ring,
  one-tile spans split over up to 2 CTAs), ``single_bf16_p``
  (``kVarqSplitP`` off), ``split_f16_p`` (``kVarqSplitPF16`` on),
  ``stages3`` (``kVarqStages`` 3: two tiles of gathers in flight) and
  ``clusterC``, C in {1, 4} (``kVarqMaxCluster``:
  1 walks a one-tile span's whole context in one CTA). With ``--kv
  float32`` (the ``wgmma_f32kv`` instance; ``parent`` is the parent's,
  the FMA kernel before this route): ``f32_tile32k``
  (``kVarqF32TileBytes`` 32 KiB: 64 keys a tile at head_dim 128, one CTA
  an SM; 16 KiB, 32 keys and two CTAs an SM with a bf16 q, shipped),
  ``f32_stages3`` (``kVarqStagesF32`` 3; 2 shipped), ``clusterC`` as
  above, and the diagnostic ``f32_no_split`` and ``f32_no_load`` as for
  ``flash_f32kv``.

Every variant is compiled with the same nvcc flags as the package and
called through the same C entries. Prints, per variant, the largest
error against the plain version with the card tolerance's verdict (bf16:
atol 5e-3, rtol 2e-2), and the median device time (``chip_smoke.time_ms``:
events around each call, inputs rotating past the 50 MB L2; the span
kernel and ``flash_f32kv`` also its CUPTI and back-to-back times) at the
shapes of ``chip_smoke.py``: flash at q[4, 512, 32, 128] causal + a
prefill mask and at the training shape q[2, 2048, 32, 128] causal (its
error over four input draws, with the first elements outside the
tolerance); paged and ragged decode at q[4, 32, 128] with contexts 557 /
300 / 97 / 1 and at a long context of 1024 / 1000 / 700 / 333 (page 16,
64 pages per sequence, the ragged meta as the serving loop builds it,
G = 256); the span kernel at the mixed shape q[4, 256, 32, 128], q_lens
256 / 1 / 1 / 97, kv_lens 512 / 301 / 98 / 97, and at the verify shape
q[4, 5, 32, 128], q_lens 5 / 5 / 5 / 5, kv_lens 561 / 305 / 101 / 5
(through the meta). Beside them: each flash variant at the first shape
without its mask (what the mask costs), SDPA at both flash shapes, and
the shipped paged decode on the ragged inputs. Needs one CUDA device and
nvcc; imports nothing of JAX.
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

NEG = -1e30
# the dtype every section runs in (``--dtype``) and its code, and the
# decode sections' page dtype (``--kv``) and its code
DT = {"name": "bfloat16", "code": 1, "kv": "bfloat16", "kv_code": 1}
CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def variants(csrc, target, consts):
    """{name: {file: text}} of the sources a variant build needs: the
    target ``.cu`` and every file of ``csrc`` a constant of the variant
    lives in, each listed (file, old, new) substitution applied; raises
    if a substitution's shipped text is no longer in its file."""
    out = {}
    for name, subs in consts.items():
        files = {target: None}
        for fname, old, new in subs:
            text = files.get(fname)
            if text is None:
                with open(os.path.join(csrc, fname)) as f:
                    text = f.read()
            if old not in text:
                raise RuntimeError(f"pattern not in {fname}: {old!r}")
            files[fname] = text.replace(old, new)
        if files[target] is None:
            with open(os.path.join(csrc, target)) as f:
                files[target] = f.read()
        out[name] = files
    return out


def build(sources, out_dir, signatures, include, kv_code):
    """Compile every variant in parallel, each in a directory of its own
    holding its changed files (they shadow those of ``include``, a
    ``csrc`` directory); returns {name: ctypes library}, each with the
    dtype ``codes`` its entry is called with (q's, then ``kv_code``). A
    library whose entry takes one dtype code (a parent before the KV
    dtype code) gets ``signatures`` without the second code, and
    ``codes`` of one."""
    from paddle_tpu_torch.kernels import _build
    procs = {}
    for name, files in sources.items():
        vdir = os.path.join(out_dir, name.replace(" ", "_"))
        os.makedirs(vdir, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        cu = os.path.join(vdir, next(f for f in files if f.endswith(".cu")))
        two = "int kv_dtype" in files[os.path.basename(cu)]
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", vdir, "-I",
             str(include), "-o", os.path.join(vdir, "lib.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), two
    libs = {}
    for name, (proc, two) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed, skipped:\n{out}", flush=True)
            continue
        lib = ctypes.CDLL(os.path.join(out_dir, name.replace(" ", "_"),
                                       "lib.so"))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            args = list(argtypes) if two else [argtypes[0], *argtypes[2:]]
            f.argtypes, f.restype = args, ctypes.c_int
        lib.codes = (DT["code"], kv_code) if two else (DT["code"],)
        libs[name] = lib
    return libs


SECTIONS = ("flash_fwd", "flash_decode", "flash_f32kv", "flash_f32",
            "paged_decode", "ragged_decode", "paged_varq")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections to run")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose ragged decode and span kernels "
                         "are timed beside these")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float16"),
                    help="the inputs' dtype in every section")
    ap.add_argument("--kv", default=None, choices=("float32",),
                    help="the decode sections' page dtype (default: "
                         "--dtype)")
    args = ap.parse_args(argv)
    kv = args.kv or args.dtype
    DT.update(name=args.dtype, code=CODES[args.dtype], kv=kv,
              kv_code=CODES[kv])
    only = set(args.only.split(","))
    if only - set(SECTIONS):
        ap.error(f"unknown sections {sorted(only - set(SECTIONS))}")
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
    print(f"card: {smi}; inputs in {args.dtype}, decode pages in {kv}",
          flush=True)
    dt = getattr(torch, args.dtype)
    tol = S.TOL[args.dtype]
    csrc = os.path.join(REPO, "paddle_tpu_torch", "csrc")
    wg, bn = "constexpr int kFwdWG = 1;", "constexpr int kFwdBN = 64;"
    st = "constexpr int kFwdStages = 2;"
    fwd = "flash_fwd.cu"
    fwd_consts = {f"wg{w}_bn{n}": [(fwd, wg, f"constexpr int kFwdWG = {w};"),
                                   (fwd, bn, f"constexpr int kFwdBN = {n};")]
                  for w in (1, 2) for n in (64, 128)}
    fwd_consts["wg1_bn64_3stages"] = [
        (fwd, st, "constexpr int kFwdStages = 3;")]
    fwd_consts["wg1_bn64_single_bf16_p"] = [(
        fwd, "constexpr bool kFwdSplitP = true;",
        "constexpr bool kFwdSplitP = false;")]
    fwd_consts["wg1_bn64_split_f16_p"] = [(
        fwd, "constexpr bool kFwdSplitPF16 = false;",
        "constexpr bool kFwdSplitPF16 = true;")]
    fwd_consts["wg1_bn64_l2_mask"] = [(
        fwd, "  const int stage = kFwdWG == 1 && mask",
        "  const int stage = false && mask")]
    split = "decode_split.cuh"
    cl = "constexpr int kMaxCluster = 4;"

    def clusters(cs):
        return {f"cluster{c}": [(split, cl,
                                 f"constexpr int kMaxCluster = {c};")]
                for c in cs}
    paged_consts = clusters((1, 2, 4, 8))
    paged_consts["cluster4_chunk64"] = [(split,
                                         "constexpr int kSplitChunk = 32;",
                                         "constexpr int kSplitChunk = 64;")]
    ragged_consts = clusters((1, 2, 4))
    slots = {f"slots{n}": [(split, "constexpr int kSplitSlots = 1024;",
                            f"constexpr int kSplitSlots = {n};")]
             for n in (512, 2048)}
    if kv == "float32":
        f32 = {"f32_chunk32": [(split, "constexpr int kSplitChunkF32 = 16;",
                                "constexpr int kSplitChunkF32 = 32;")]}
        f32.update({f"f32_stages{n}": [(
            split, "constexpr int kSplitStagesF32 = 3;",
            f"constexpr int kSplitStagesF32 = {n};")] for n in (2, 4)})
        del paged_consts["cluster4_chunk64"]
        paged_consts.update(f32, **slots)
        ragged_consts.update(f32, **slots)
    decode_consts = {"shipped": [], **clusters((1, 2, 8)), **slots}
    for n in (2048, 8192):
        decode_consts[f"stage{n}"] = [(
            split, "constexpr int kDenseStageBytes = 4096;",
            f"constexpr int kDenseStageBytes = {n};")]
    for n in (3, 4):
        decode_consts[f"stages{n}"] = [(split,
                                        "constexpr int kDenseStages = 2;",
                                        f"constexpr int kDenseStages = {n};")]
    decode_consts["all_keys"] = [(split,
                                  "constexpr bool kDenseWindow = true;",
                                  "constexpr bool kDenseWindow = false;")]
    vq = "paged_varq.cu"
    varq_consts = {"shipped": [], "single_bf16_p": [(
        vq, "constexpr bool kVarqSplitP = true;",
        "constexpr bool kVarqSplitP = false;")], "split_f16_p": [(
            vq, "constexpr bool kVarqSplitPF16 = false;",
            "constexpr bool kVarqSplitPF16 = true;")]}
    varq_consts["stages3"] = [(vq, "constexpr int kVarqStages = 2;",
                               "constexpr int kVarqStages = 3;")]
    for c in (1, 4):
        varq_consts[f"cluster{c}"] = [(
            vq, "constexpr int kVarqMaxCluster = 2;",
            f"constexpr int kVarqMaxCluster = {c};")]
    if kv == "float32":
        varq_consts = {n: varq_consts[n]
                       for n in ("shipped", "cluster1", "cluster4")}
        for name, nb, n in (("f32_tile32k", 32768, 2),
                            ("f32_stages3", 16384, 3)):
            varq_consts[name] = [
                (vq, "constexpr int kVarqF32TileBytes = 16384;",
                 f"constexpr int kVarqF32TileBytes = {nb};"),
                (vq, "constexpr int kVarqStagesF32 = 2;",
                 f"constexpr int kVarqStagesF32 = {n};")]
    no_split = [("      split_tile<BN, D, NT>(sK, sKl, f, tid);\n", ""),
                ("      split_tile<BN, D, NT>(sV, sVl, f + F_BYTES, tid);\n",
                 "")]
    if kv == "float32":
        varq_consts["f32_no_split"] = [(vq, a, b) for a, b in no_split]
        varq_consts["f32_no_load"] = [(
            vq, "      stage_rows<BN, D, NT>(f, k_pages",
            "      if (false) stage_rows<BN, D, NT>(f, k_pages")]
    fwd_no_split = [(a.replace("NT>(sK, sKl, f, tid)",
                               "NT, L::KP>(sK, sKl, f, tid, sK2)")
                     .replace("NT>(sV, sVl, f + F_BYTES, tid)",
                              "NT, L::KP>(sV, sVl, f + F_BYTES, tid, sV2)"),
                     b) for a, b in no_split]
    f32kv_consts = {"shipped": [],
                    "f32_no_split": [(fwd, a, b) for a, b in fwd_no_split],
                    "f32_no_load": [(fwd, "      stage_rows<BN, D, NT>(\n",
                                     "      if (false) stage_rows<BN, D, "
                                     "NT>(\n")]}
    for name, n in (("f32_bn32", 3), ("f32_bn32_stages2", 2)):
        f32kv_consts[name] = [
            (fwd, "constexpr int kFwdBNF32 = 64;",
             "constexpr int kFwdBNF32 = 32;"),
            (fwd, "constexpr int kFwdStagesF32 = 2;",
             f"constexpr int kFwdStagesF32 = {n};")]
    tmp = tempfile.mkdtemp(prefix="kernel_variants_")
    want = {"flash_fwd": (fwd, fwd_consts, A._SIGNATURES),
            "flash_decode": (fwd, decode_consts, A._SIGNATURES),
            "flash_f32kv": (fwd, f32kv_consts, A._SIGNATURES),
            "flash_f32": (fwd, {"shipped": [],
                                "f32_no_split": f32kv_consts["f32_no_split"],
                                "f32_l2_mask": fwd_consts[
                                    "wg1_bn64_l2_mask"]},
                          A._SIGNATURES),
            "paged_decode": ("paged_decode.cu", paged_consts,
                             P._SIGNATURES["paged_decode"]),
            "ragged_decode": ("ragged_decode.cu", ragged_consts,
                              P._SIGNATURES["ragged_decode"]),
            "paged_varq": (vq, varq_consts, P._SIGNATURES["paged_varq"])}
    libs = {}
    for sec in SECTIONS:
        if sec not in only:
            continue
        target, consts, sig = want[sec]
        # the flash sections run q, k and v of one dtype, but flash_f32kv
        # f32 K/V (flash_f32 passes its own codes)
        kv_code = CODES["float32"] if sec == "flash_f32kv" else \
            DT["code"] if sec.startswith("flash") else DT["kv_code"]
        libs[sec] = {}
        if args.parent and sec != "flash_fwd":
            pdir = os.path.join(os.path.abspath(args.parent),
                                "paddle_tpu_torch", "csrc")
            libs[sec].update(build(variants(pdir, target, {"parent": []}),
                                   os.path.join(tmp, sec), sig, pdir,
                                   kv_code))
        libs[sec].update(build(variants(csrc, target, consts),
                               os.path.join(tmp, sec), sig, csrc, kv_code))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def med(fn, sets):
        return S.time_ms(torch, fn, sets, iters=args.iters)["median"]

    def med_all(fn, sets):
        """"median ms (CUPTI ms; back to back ms)" of ``S.time_ms``."""
        t = S.time_ms(torch, fn, sets, iters=args.iters)
        return f"{t['median']:.4f} ms (CUPTI {t['cupti']:.4f}; back to " \
               f"back {t['queue']:.4f})"

    def verdict(got, want, rows=None):
        """Largest error and the count outside tolerance, with the index,
        value and reference of the first few elements outside it."""
        got, want = got.float(), want.float()
        if rows is not None:
            got, want = got[rows], want[rows]
        bad = ~torch.isclose(got, want, **tol)
        where = [(tuple(i.tolist()), round(float(got[tuple(i)]), 5),
                  round(float(want[tuple(i)]), 5))
                 for i in bad.nonzero()[:4]]
        return f"max abs err {float((got - want).abs().max()):.3e}, " \
               f"{int(bad.sum())} outside tolerance {where or ''}"

    if "flash_fwd" in libs:
        flash_section(torch, S, A, libs["flash_fwd"], dev, g, med, verdict,
                      dt)
    if "flash_decode" in libs:
        flash_decode_section(torch, S, A, libs["flash_decode"], dev, g, med,
                             verdict)
    if "flash_f32kv" in libs:
        flash_f32kv_section(torch, S, A, libs["flash_f32kv"], dev, g,
                            med_all, verdict, dt)
    if "flash_f32" in libs:
        flash_f32_section(torch, S, A, libs["flash_f32"], dev, g, med_all)
    if only & {"paged_decode", "ragged_decode", "paged_varq"}:
        decode_sections(torch, S, A, P, libs, dev, g, med, verdict, dt,
                        med_all)
    return 0


def flash_section(torch, S, A, fwd_libs, dev, g, med, verdict, dt):
    def fwd(lib, q, k, v, mask, causal):
        return flash_fwd_call(torch, A, dev, lib, q, k, v, mask, causal)

    def qkv(b, s, h):
        return [tuple(torch.randn(b, s, h, 128, device=dev,
                                  generator=g).to(dt) for _ in range(3))
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
    full = (mask + torch.where(causal, 0.0, NEG)).to(dt)

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


def flash_fwd_call(torch, A, dev, lib, q, k, v, mask, causal, codes=None,
                   drop=(None, 0, 0.0)):
    """One launch of ``lib``'s flash_fwd entry (no kv_lens), with the
    dtype ``codes`` (default ``lib.codes``) and the dropout arguments
    ``drop`` (``attention._dropout_args``; none by default); returns the
    output."""
    b, sq, h, d = q.shape
    m_ptr, *strides = A._mask_args(mask, k.shape[1])
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    codes = lib.codes if codes is None else codes[:len(lib.codes)]
    err = lib.flash_fwd(*codes, d, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), m_ptr, None, out.data_ptr(),
                        lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2],
                        *strides, float(d ** -0.5), int(causal), *drop,
                        A.stream_ptr(dev))
    if err:
        raise RuntimeError(f"flash_fwd: CUDA error {err} at launch")
    return out


def flash_f32kv_section(torch, S, A, libs, dev, g, med, verdict, dt):
    """Each variant of the forward with q of ``dt`` over f32 K/V (and the
    parent's instance) at the suffix-prefill shape, 32 and 4 KV heads,
    beside the bound (operations at the 16-bit peak, ``S.ops_type``)."""
    sq, sk, h, d = 128, 384, 32, 128
    m = S.suffix_mask(torch, dev, sq, sk)
    kept = int((m > NEG / 2).sum()) * h
    for hkv in (32, 4):
        sets = [(torch.randn(1, sq, h, d, device=dev, generator=g).to(dt),)
                + tuple(torch.randn(1, sk, hkv, d, device=dev, generator=g)
                        for _ in range(2)) for _ in range(2)]
        isz = sets[0][0].element_size()
        b_ms, by = S.bound(2 * sq * h * d * isz + 2 * sk * hkv * d * 4
                           + m.numel() * 4 + h * sq * 4, 4 * d * kept,
                           S.ops_type(DT["name"], "float32"))
        want = A.flash_attention_plain(*sets[0], d ** -0.5, False, m)
        print(f"flash_f32kv q[1, {sq}, {h}, {d}] {DT['name']}, k, v[1, {sk}, "
              f"{hkv}, {d}] float32, suffix mask: bound {b_ms:.4f} ms ({by})",
              flush=True)
        for name, lib in libs.items():
            def run(q, k, v, lib=lib):
                return flash_fwd_call(torch, A, dev, lib, q, k, v, m, False)
            t = med(run, sets)
            print(f"flash_f32kv {name} Hkv={hkv}: {t}; "
                  f"{verdict(run(*sets[0]), want)}", flush=True)


def flash_f32_section(torch, S, A, libs, dev, g, med):
    """Each f32 forward (the shipped ``wgmma_f32`` instance, the parent's
    and the diagnostic variant) at BERT-base's shape with its key mask,
    without and with dropout 0.1, and at q[4, 512, 32, 128] causal + a
    prefill mask, beside f32 SDPA and the bytes bound (f32 Q, K, V, O, the
    mask and lse once); errors against the plain version at the f32
    tolerance."""
    F = torch.nn.functional
    tol = S.TOL["float32"]
    lens = torch.tensor([512, 384, 200, 64], device=dev)
    pmask, key_valid = S.prefill_mask(torch, dev, lens, 512)
    causal = torch.tril(torch.ones(512, 512, dtype=torch.bool, device=dev))
    shapes = (("bert", 16, 128, 12, 64, False, S.bert_key_mask(torch, dev),
               None, 0.0),
              ("bert_dropout", 16, 128, 12, 64, False,
               S.bert_key_mask(torch, dev), None, 0.1),
              ("prefill_d128", 4, 512, 32, 128, True, pmask, key_valid, 0.0))
    for label, b, s, h, d, cz, mask, rows, p in shapes:
        # input sets past the 50 MB L2 (6.3 MB each at BERT's shape)
        n = max(2, -(-64_000_000 // (3 * b * s * h * d * 4)))
        sets = [tuple(torch.randn(b, s, h, d, device=dev, generator=g)
                      for _ in range(3)) for _ in range(n)]
        seeds = (-1234567891, 987654321)
        kw = dict(dropout_p=p, seeds=seeds) if p else {}
        drop = A._dropout_args(p, A.seed_slot(p, seeds, dev))
        want = A.flash_attention_plain(*sets[0], d ** -0.5, cz, mask, **kw)
        full = mask + torch.where(causal, 0.0, S.NEG) if cz else mask
        sdpa = med(lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            attn_mask=full, dropout_p=p, scale=d ** -0.5), sets)
        kept = (full > S.NEG / 2).expand(b, 1, s, s).sum().item() * h
        b_ms, by = S.bound(4 * b * s * h * d * 4 + mask.numel() * 4
                           + b * h * s * 4, 4 * d * kept, "bfloat16")
        print(f"flash_f32 {label} q[{b}, {s}, {h}, {d}] float32: bound "
              f"{b_ms:.4f} ms ({by}); SDPA {sdpa}", flush=True)
        for name, lib in libs.items():
            def run(q, k, v, lib=lib):
                return flash_fwd_call(torch, A, dev, lib, q, k, v, mask, cz,
                                      codes=(0, 0), drop=drop)
            got, w = run(*sets[0]).float(), want.float()
            if rows is not None:
                got, w = got[rows], w[rows]
            ok = torch.allclose(got, w, **tol)
            print(f"flash_f32 {name} {label}: {med(run, sets)}; max abs err "
                  f"{float((got - w).abs().max()):.3e} "
                  f"{'ok' if ok else 'outside the f32 tolerance'}",
                  flush=True)


def flash_decode_section(torch, S, A, libs, dev, g, med, verdict):
    """Each decode-route variant (and the parent's forward) at the static
    route's three decode shapes, beside SDPA and the bytes bound."""
    F = torch.nn.functional
    beam = [n for n in S.GPT_LENS for _ in range(S.GPT_BEAMS)]
    shapes = (("llama", 8, 32, 128, S.INFER_LENS[0], 512),
              ("gpt_beam", len(beam), 25, 64, beam, max(S.GPT_LENS)),
              ("gpt_greedy", len(S.GPT_LENS), 25, 64, S.GPT_LENS,
               max(S.GPT_LENS)))
    for label, b, h, d, lens, s in shapes:
        per = 2 * b * (s + S.INFER_NEW) * h * d * 2
        sets, keep, madd, nbytes, pairs = S.static_decode_case(
            torch, dev, g, b, h, d, lens, s, DT["name"],
            sets=max(2, -(-64_000_000 // per)))
        b_ms, by = S.bound(nbytes, 4 * d * pairs, DT["name"])
        want = A.flash_attention_plain(*sets[0], d ** -0.5, False, madd)
        sdpa = med(lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=keep, scale=d ** -0.5), sets)
        print(f"flash_decode {label} q[{b}, 1, {h}, {d}] k, v[{b}, "
              f"{s + S.INFER_NEW}, {h}, {d}]: bound {b_ms:.4f} ms ({by}), "
              f"SDPA (same mask) {sdpa:.4f} ms", flush=True)
        for name, lib in libs.items():
            def run(q, k, v, lib=lib):
                return flash_fwd_call(torch, A, dev, lib, q, k, v, madd,
                                      False)
            t = med(run, sets)
            print(f"flash_decode {name} {label}: {t:.4f} ms; "
                  f"{verdict(run(*sets[0]), want)}", flush=True)


def decode_sections(torch, S, A, P, libs, dev, g, med, verdict, dt,
                    med_all):
    b, d, page, pps, h, hkv = 4, 128, 16, 64, 32, 32
    num_pages = b * pps + 1
    sc = d ** -0.5
    tables = torch.randperm(num_pages, device=dev, generator=g)[
        :b * pps].reshape(b, pps).to(torch.int32).contiguous()
    q = torch.randn(b, h, d, device=dev, generator=g).to(dt)
    kt = getattr(torch, DT["kv"])
    sets = [tuple(torch.randn(num_pages, page, hkv, d, device=dev,
                              generator=g).to(kt) for _ in range(2))
            for _ in range(4)]

    def call(lib, fn, *args):
        err = getattr(lib, fn)(*args, A.stream_ptr(dev))
        if err:
            raise RuntimeError(f"{fn}: CUDA error {err} at launch")

    def paged(lib, kp, vp, ctx):
        out = torch.empty_like(q)
        call(lib, "paged_decode", *lib.codes, d, q.data_ptr(), kp.data_ptr(),
             vp.data_ptr(), tables.data_ptr(), ctx.data_ptr(),
             out.data_ptr(), b, h, hkv, page, pps, num_pages, sc)
        return out

    def ragged(lib, kp, vp, ctx, meta, ws):
        out = torch.empty_like(q)
        call(lib, "ragged_decode", *lib.codes, d, q.data_ptr(), kp.data_ptr(),
             vp.data_ptr(), meta.data_ptr(), ctx.data_ptr(), out.data_ptr(),
             ws.data_ptr(), b, h, hkv, page, num_pages, meta.shape[1], sc)
        return out

    for ctx_list in ([557, 300, 97, 1], [1024, 1000, 700, 333]):
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device=dev)
        want = P.paged_attention_plain(q, *sets[0], tables, ctx, sc)
        meta = S._builder_meta(torch, dev, tables, ctx, page)
        # the parent's two-pass kernel takes a workspace in bf16 too
        ws = torch.empty(meta.shape[1] * h * (d + 2), device=dev)
        t_p = med(lambda kp, vp: P.paged_attention_kernel(
            q, kp, vp, tables, ctx, sc), sets)
        print(f"paged_decode (shipped) at ctx {ctx_list}: {t_p:.4f} ms",
              flush=True)
        for name, lib in libs.get("paged_decode", {}).items():
            t = med(lambda kp, vp: paged(lib, kp, vp, ctx), sets)
            print(f"paged_decode {name} ctx {ctx_list}: {t:.4f} ms; "
                  f"{verdict(paged(lib, *sets[0], ctx), want)}", flush=True)
        for name, lib in libs.get("ragged_decode", {}).items():
            t = med(lambda kp, vp: ragged(lib, kp, vp, ctx, meta, ws), sets)
            print(f"ragged_decode {name} ctx {ctx_list} G={meta.shape[1]}: "
                  f"{t:.4f} ms; "
                  f"{verdict(ragged(lib, *sets[0], ctx, meta, ws), want)}",
                  flush=True)
    if "paged_varq" in libs:
        varq_section(torch, S, A, P, libs["paged_varq"], dev, g, med_all,
                     verdict, tables, sets, page, dt)


def varq_section(torch, S, A, P, libs, dev, g, med, verdict, tables, sets,
                 page, dt):
    b, pps = tables.shape
    num_pages, _, hkv, d = sets[0][0].shape
    h, sc = 32, d ** -0.5
    for qb, q_lens, kv_lens in ((256, [256, 1, 1, 97], [512, 301, 98, 97]),
                                (5, [5, 5, 5, 5], [561, 305, 101, 5])):
        q = torch.randn(b, qb, h, d, device=dev, generator=g).to(dt)
        ql, kl = (torch.tensor(x, dtype=torch.int32, device=dev)
                  for x in (q_lens, kv_lens))
        meta = S._builder_meta(torch, dev, tables, kl, page)
        rows = torch.arange(qb, device=dev)[None, :] < ql[:, None]
        want = P.paged_attention_ragged_varq_plain(q, *sets[0], kl, ql, meta,
                                                   sc)

        def run(lib, kp, vp):
            out = torch.empty_like(q)
            err = lib.paged_varq(*lib.codes, d, q.data_ptr(), kp.data_ptr(),
                                 vp.data_ptr(), None, meta.data_ptr(),
                                 kl.data_ptr(), ql.data_ptr(), out.data_ptr(),
                                 b, qb, h, hkv, page, pps, num_pages,
                                 meta.shape[1], sc, A.stream_ptr(dev))
            if err:
                raise RuntimeError(f"paged_varq: CUDA error {err} at launch")
            return out
        b_ms, by = S.varq_bound(q, ql, kl, hkv, meta,
                                kv_isz=sets[0][0].element_size(),
                                op_type=S.ops_type(DT["name"], DT["kv"]))
        print(f"paged_varq at q[{b}, {qb}, {h}, {d}] q_lens {q_lens} kv_lens "
              f"{kv_lens}: bound {b_ms:.4f} ms ({by})", flush=True)
        for name, lib in libs.items():
            t = med(lambda kp, vp: run(lib, kp, vp), sets)
            print(f"paged_varq {name} qb {qb}: {t}; "
                  f"{verdict(run(lib, *sets[0]), want, rows)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
