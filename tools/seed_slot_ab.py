#!/usr/bin/env python3
"""The flash kernels with their dropout seeds read from a device slot
(this checkout) against a checkout that passes them by value (``--parent
DIR``, a ``git archive`` of that commit unpacked anywhere), in one
process on one GPU.

    python3 tools/seed_slot_ab.py --parent DIR [--iters 24]

At BERT-base's fine-tune shape q[16, 128, 12, 64] with its key mask
(``chip_smoke.bert_key_mask``), f32 and bf16, without dropout and with
dropout 0.1 at one seed pair: each side's ``flash_fwd``, ``flash_bwd_dkdv``
and ``flash_bwd_dq`` must give the other's outputs bit for bit (the same
two words, the same pattern), and each is timed in the order parent,
this, this, parent (``chip_smoke.time_ms``: the median of CUDA events
around each call, inputs rotating past the 50 MB L2, with the CUPTI and
back-to-back times). Needs nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEEDS = (-1234567891, 987654321)


def parent_libs(torch, A, parent):
    """The parent's flash_fwd and flash_bwd libraries, bound with the
    by-value seed arguments (int seed0, int seed1) in the slot's place."""
    from paddle_tpu_torch.kernels import _build
    csrc = os.path.join(os.path.abspath(parent), "paddle_tpu_torch", "csrc")
    out = tempfile.mkdtemp(prefix="seed_slot_ab_")
    p_, i_, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dims = [i_, i_, i_, i_, i_, ll, ll, ll, ll, ctypes.c_float, i_,
            i_, i_, ctypes.c_uint, ctypes.c_float, p_]
    sigs = {"flash_fwd": {"flash_fwd": [i_, i_, i_, *[p_] * 7, *dims]},
            "flash_bwd": {"flash_bwd_dkdv": [i_, i_, *[p_] * 10, *dims],
                          "flash_bwd_dq": [i_, i_, *[p_] * 9, *dims]}}

    def build(name):
        so = os.path.join(out, f"{name}.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", so, os.path.join(csrc, f"{name}.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in sigs[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
        return lib
    with ThreadPoolExecutor(2) as ex:
        return dict(zip(sigs, ex.map(build, sigs)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", required=True)
    ap.add_argument("--iters", type=int, default=24)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("seed_slot_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from paddle_tpu_torch.kernels import attention as A
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    old = parent_libs(torch, A, args.parent)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, h, d = 16, 128, 12, 64
    sc = d ** -0.5
    mask = S.bert_key_mask(torch, dev, b, s)
    m_ptr, *strides = A._mask_args(mask, s)
    code = {torch.float32: 0, torch.bfloat16: 1}

    def by_value(p):
        if not p:
            return 0, 0, 0, 0.0
        return (*SEEDS, A.dropout_threshold(p), 1.0 / (1.0 - p))

    def old_fwd(p, q, k, v, *_):
        out = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        A.check(old["flash_fwd"].flash_fwd(
            code[q.dtype], code[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), m_ptr, None, out.data_ptr(), lse.data_ptr(), b, s,
            s, h, h, *strides, sc, 0, *by_value(p), A.stream_ptr(dev)),
            "parent flash_fwd")
        return out, lse

    def old_bwd(which, p, q, k, v, do, lse, delta):
        head, dims = A._bwd_args("parent", q, k, v, do, lse, delta, mask,
                                 None)
        tail = (sc, 0, *by_value(p), A.stream_ptr(dev))
        if which == "dkdv":
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            A.check(old["flash_bwd"].flash_bwd_dkdv(
                *head, dk.data_ptr(), dv.data_ptr(), *dims, *tail),
                "parent flash_bwd_dkdv")
            return dk, dv
        dq = torch.empty_like(q)
        A.check(old["flash_bwd"].flash_bwd_dq(*head, dq.data_ptr(), *dims,
                                              *tail), "parent flash_bwd_dq")
        return (dq,)

    for dtype in (torch.float32, torch.bfloat16):
        for p in (0.0, 0.1):
            slot = A.seed_slot(p, SEEDS, dev)
            kw = dict(dropout_p=p, seeds=slot)

            def inputs():
                q, k, v, do = (torch.randn(b, s, h, d, device=dev,
                                           generator=g).to(dtype)
                               for _ in range(4))
                out, lse = A.flash_attention_kernel(q, k, v, sc, False, mask,
                                                    **kw)
                return q, k, v, do, lse, A.bwd_delta(out, do)
            sets = [inputs() for _ in range(4)]
            new = {
                "flash_fwd": lambda q, k, v, *_: A.flash_attention_kernel(
                    q, k, v, sc, False, mask, **kw),
                "flash_bwd_dkdv": lambda q, k, v, do, lse, dl:
                    A.flash_bwd_dkdv_kernel(q, k, v, do, lse, dl, sc, False,
                                            mask, **kw),
                "flash_bwd_dq": lambda q, k, v, do, lse, dl: (
                    A.flash_bwd_dq_kernel(q, k, v, do, lse, dl, sc, False,
                                          mask, **kw),)}
            par = {"flash_fwd": lambda *a: old_fwd(p, *a),
                   "flash_bwd_dkdv": lambda *a: old_bwd("dkdv", p, *a),
                   "flash_bwd_dq": lambda *a: old_bwd("dq", p, *a)}
            label = f"{str(dtype).split('.')[-1]} q[{b}, {s}, {h}, {d}] " \
                    f"key mask, p={p}"
            for name in new:
                same = all(torch.equal(x, y) for x, y in
                           zip(new[name](*sets[0]), par[name](*sets[0])))
                times = [S.time_ms(torch, fn, sets, iters=args.iters)
                         for fn in (par[name], new[name], new[name],
                                    par[name])]
                print(f"{name} {label}: bitwise equal to the parent's "
                      f"{same}; median ms P C C P " + " ".join(
                          f"{t['median']:.4f}" for t in times)
                      + "; CUPTI " + " ".join(f"{t['cupti']:.4f}"
                                              for t in times), flush=True)
                S.check(same, f"{name} {label}: outputs differ from the "
                        "parent's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
