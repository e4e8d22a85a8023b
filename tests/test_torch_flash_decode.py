"""The one-row decode route of the flash forward and the split decode walk
over f32 pages: which device kernel a launch takes, and the kernels
against their plain versions on the card.

The route rule lives in the C entries (``decode_route`` in
csrc/flash_fwd.cu, ``dec::splits`` in csrc/decode_split.cuh) and is
mirrored by ``attention.fwd_route`` and ``paged_attention.decode_route``;
the CPU cases pin the mirror (and the constant it shares with the C
source). The ``cuda`` cases hold each route to its plain version at the
geometries the static route and an f32 KV pool give it, with a bitwise
second launch, and skip without a card. This file imports no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_flash_decode.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.kernels import paged_attention as P
from paddle_tpu_torch.kernels import reset_launch_counts, route_counts
from paddle_tpu_torch.kernels.paged_attention import RaggedMetaBuilder

NEG = -1e30
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------- the route rule --

# (q dtype, K/V dtype, Sq, H, Hkv, dropout_p) -> the forward's device kernel
FWD_ROUTES = [
    ((BF16, BF16, 1, 32, 32, 0.0), "decode"),
    ((F16, F16, 1, 25, 25, 0.0), "decode"),
    ((BF16, BF16, 1, 32, 4, 0.0), "decode"),
    ((BF16, BF16, 1, 64, 1, 0.0), "decode"),    # the largest group
    ((BF16, BF16, 1, 65, 1, 0.0), "wgmma"),     # past it
    ((BF16, BF16, 2, 32, 32, 0.0), "wgmma"),
    ((F16, F16, 512, 32, 8, 0.0), "wgmma"),
    ((BF16, BF16, 1, 32, 32, 0.1), "wgmma"),    # dropout
    ((F32, F32, 1, 32, 32, 0.0), "fma"),
    ((BF16, F32, 1, 32, 32, 0.0), "fma"),
    ((F32, BF16, 1, 32, 32, 0.0), "fma"),
    ((F16, BF16, 1, 32, 32, 0.0), "fma"),
    ((BF16, F32, 128, 32, 32, 0.0), "wgmma_f32kv"),   # the suffix prefill
    ((F16, F32, 2, 32, 4, 0.0), "wgmma_f32kv"),
    ((F16, F32, 1, 32, 4, 0.0), "fma"),               # Sq = 1 stays
    ((BF16, F32, 128, 32, 32, 0.1), "fma"),           # dropout (refused)
    ((F32, F32, 128, 32, 32, 0.0), "wgmma_f32"),      # f32 over bf16 parts
    ((F32, F32, 128, 12, 12, 0.1), "wgmma_f32"),      # with dropout
    ((F32, F32, 2, 32, 4, 0.0), "wgmma_f32"),
    ((F32, BF16, 128, 32, 32, 0.0), "fma"),
    ((BF16, F16, 128, 32, 32, 0.0), "fma"),
    ((BF16, BF16, 128, 32, 8, 0.0), "wgmma"),
]


@pytest.mark.parametrize("args,route", FWD_ROUTES,
                         ids=[f"{r}-{i}" for i, (_, r) in
                              enumerate(FWD_ROUTES)])
def test_fwd_route_rule(args, route):
    """Sq = 1 in one 16-bit dtype without dropout takes the decode route;
    Sq > 1 or dropout keep the tensor-core kernel; f32 at Sq > 1, with or
    without dropout, the tensor-core kernel over bf16 parts of every
    operand; a 16-bit q over f32 K/V at Sq > 1 without dropout the
    tensor-core kernel over bf16 parts of K/V; f32 at Sq = 1 and the other
    pairs of dtypes the FMA kernel."""
    assert A.fwd_route(*args) == route


# (q dtype, page dtype) -> the decode entries' device kernel
DECODE_ROUTES = [((BF16, BF16), "split"), ((F16, F16), "split"),
                 ((BF16, F32), "split"), ((F16, F32), "split"),
                 ((F32, F32), "fma"), ((F32, BF16), "fma"),
                 ((F32, F16), "fma"), ((BF16, F16), "fma"),
                 ((F16, BF16), "fma")]


@pytest.mark.parametrize("dtypes,route", DECODE_ROUTES,
                         ids=[f"{str(q)[6:]}-{str(k)[6:]}" for (q, k), _ in
                              DECODE_ROUTES])
def test_decode_route_rule(dtypes, route):
    """A 16-bit q over pages of its dtype or of f32 takes the split walk;
    f32 q, and bf16 with f16, the FMA kernels."""
    assert P.decode_route(*dtypes) == route


# (q dtype, page dtype) -> paged_varq's device kernel
VARQ_ROUTES = [((BF16, BF16), "wgmma"), ((F16, F16), "wgmma"),
               ((BF16, F32), "wgmma_f32kv"), ((F16, F32), "wgmma_f32kv"),
               ((F32, F32), "fma"), ((F32, BF16), "fma"),
               ((F32, F16), "fma"), ((BF16, F16), "fma"),
               ((F16, BF16), "fma")]


@pytest.mark.parametrize("dtypes,route", VARQ_ROUTES,
                         ids=[f"{str(q)[6:]}-{str(k)[6:]}" for (q, k), _ in
                              VARQ_ROUTES])
def test_varq_route_rule(dtypes, route):
    """One 16-bit dtype takes the tensor-core kernel, a 16-bit q over f32
    pages the same kernel over bf16 parts of the pages; f32 q, and bf16
    with f16, the FMA kernel."""
    assert P.varq_route(*dtypes) == route


def test_route_rule_mirrors_the_sources():
    """The Python mirrors name the C sources' constant and conditions."""
    csrc = Path(A.__file__).resolve().parent.parent / "csrc"
    fwd = (csrc / "flash_fwd.cu").read_text()
    m = re.search(r"constexpr int kDecodeMaxGroup = (\d+);", fwd)
    assert m and int(m.group(1)) == A.DECODE_MAX_GROUP
    assert "Sq == 1 && !(dscale > 0.f) &&" in fwd
    assert ("        constexpr bool F32 =\n"
            "            std::is_same<TQ, float>::value && "
            "std::is_same<TKV, float>::value;\n"
            "        if constexpr (F32 || tc::f32_kv<TQ, TKV>()) {\n"
            "          if (Sq > 1 && (F32 || !(dscale > 0.f))) {") in fwd
    assert ("return !std::is_same<TQ, float>::value && std::is_same<TKV, "
            "float>::value;") in (csrc / "wgmma.cuh").read_text()
    assert ("constexpr bool ONE = std::is_same<TQ, TKV>::value &&\n"
            "                           !std::is_same<TQ, float>::value;\n"
            "      if constexpr (ONE || tc::f32_kv<TQ, TKV>()) {") in (
        csrc / "paged_varq.cu").read_text()
    split = (csrc / "decode_split.cuh").read_text()
    assert ("!std::is_same<TQ, float>::value &&\n         (std::is_same<TQ,"
            " TKV>::value || std::is_same<TKV, float>::value)") in split
    for name in ("paged_decode.cu", "ragged_decode.cu"):
        assert "dec::splits<TQ, TKV>()" in (csrc / name).read_text()


def test_cpu_tensors_count_no_route():
    """CPU tensors take the plain versions: no launch, no route."""
    reset_launch_counts()
    q = torch.randn(2, 1, 4, 64).bfloat16()
    A.flash_attention_bshd(q, q, q, attn_mask=torch.ones(2, 1, 1, 1,
                                                         dtype=torch.bool))
    kp = torch.randn(3, 4, 2, 64)
    P.paged_attention(torch.randn(1, 2, 64).bfloat16(), kp, kp,
                      torch.tensor([[0, 1]], dtype=torch.int32),
                      torch.tensor([5], dtype=torch.int32))
    assert not route_counts


# --------------------------------------------------- the decode route --

# card tolerances (as test_torch_kernels.py's CARD_TOL): the kernel keeps
# P in f32, the plain version rounds the normalised P to V's dtype, and
# both round the output
CARD_TOL = {BF16: dict(atol=5e-3, rtol=2e-2), F16: dict(atol=1e-3, rtol=4e-3)}
F32_TOL = dict(atol=1e-4, rtol=1e-4)

# (H, Hkv, D, Sk, mask, kv_lens, causal): GQA groups 1, 4 and 8 at D 64
# and 128, Sk 1 / 65 / 332 / 544; "window" the static route's left-padded
# window that ends before Sk (the last row keeps no key), "head" a random
# additive mask per head with -1e30 entries, "broadcast" one additive row
# for every sequence and head
DECODE_GEOMS = [
    (32, 32, 128, 544, "window", False, False),
    (25, 25, 64, 332, "window", False, False),
    (32, 8, 128, 332, "head", False, False),
    (32, 4, 64, 65, "head", False, False),
    (16, 4, 64, 544, "broadcast", False, False),
    (32, 4, 128, 65, None, True, False),
    (8, 8, 128, 544, "window", True, False),
    (32, 32, 128, 1, None, False, False),
    (16, 2, 64, 65, "window", False, True),
    (16, 16, 64, 1, "head", False, False),
]


def _decode_case(rs, h, hkv, d, sk, kind, with_lens, causal, b=4):
    """(q, k, v, mask, kv_lens) as numpy, and the (row, head) pairs with a
    kept key [B, H]."""
    q = rs.randn(b, 1, h, d).astype(np.float32)
    k, v = (rs.randn(b, sk, hkv, d).astype(np.float32) for _ in range(2))
    j = np.arange(sk)
    mask = None
    if kind == "window":
        lo = np.array([0, sk // 3, sk // 2, sk])
        hi = np.array([sk, sk - sk // 4, sk // 2 + 8, sk])
        keep = (j[None] >= lo[:, None]) & (j[None] < hi[:, None])
        mask = np.where(keep, 0.0, NEG).astype(np.float32)[:, None, None]
    elif kind in ("head", "broadcast"):
        rows = (b, h) if kind == "head" else (1, 1)
        mask = np.where(rs.rand(*rows, 1, sk) < 0.3, NEG,
                        2 * rs.randn(*rows, 1, sk)).astype(np.float32)
    lens = np.array([sk, max(sk // 2, 1), 1, 0], np.int32) \
        if with_lens else None
    s = np.zeros((b, h, 1, sk), np.float32)
    if mask is not None:
        s = s + mask
    if causal:
        s = np.where(j[None, None, None] <= 0, s, NEG)
    if lens is not None:
        s = np.where(j[None, None, None] < lens[:, None, None, None], s, NEG)
    return q, k, v, mask, lens, (s > NEG / 2).any(-1)[..., 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
@pytest.mark.parametrize("geom", DECODE_GEOMS,
                         ids=[f"h{g[0]}_hkv{g[1]}_d{g[2]}_sk{g[3]}_{g[4]}"
                              f"{'_lens' if g[5] else ''}"
                              f"{'_causal' if g[6] else ''}"
                              for g in DECODE_GEOMS])
def test_decode_route_matches_plain(cuda, dtype, geom):
    """Each launch takes the decode route; the output within the card
    tolerance of the plain version where a key is kept, lse within f32's
    there and exactly -1e30 where none is, and a second launch bitwise
    equal to the first."""
    rs = np.random.RandomState(7)
    q, k, v, mask, lens, valid = _decode_case(rs, *geom)
    causal = geom[6]
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask).to(cuda)
    kl = None if lens is None else torch.from_numpy(lens).to(cuda)
    args = (q, k, v, 0.125, causal, m, kl)
    reset_launch_counts()
    out, lse = A.flash_attention_kernel(*args)
    assert dict(route_counts) == {("flash_fwd", "decode"): 1}
    want, want_lse = A.flash_attention_plain(*args, return_lse=True)
    vm = torch.from_numpy(valid).to(cuda)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out[:, 0][vm].float(),
                               want[:, 0][vm].float(), **CARD_TOL[dtype])
    torch.testing.assert_close(lse[..., 0][vm], want_lse[..., 0][vm],
                               **F32_TOL)
    assert (lse[..., 0][~vm] == NEG).all()
    again = A.flash_attention_kernel(*args)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# ----------------------------------------- the split walk over f32 pages --

# (H, Hkv, D): GQA groups 1, 4, 8 and 32 (the largest at D = 128)
F32_PAGE_GEOMS = [(8, 8, 128), (4, 4, 64), (16, 4, 64), (32, 4, 128),
                  (32, 1, 128)]
# a 512-token table over 8 ranks' shares: contexts 0, 1, 63-65, 127-129,
# 512 and past it (as test_torch_kernels.py's PAGED_GEOMETRIES)
F32_PAGE_CTX = [0, 1, 63, 64, 65, 127, 128, 129, 512, 600]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
@pytest.mark.parametrize("geom", F32_PAGE_GEOMS,
                         ids=[f"h{h}_hkv{hk}_d{d}" for h, hk, d in
                              F32_PAGE_GEOMS])
def test_split_walk_over_f32_pages(cuda, dtype, geom):
    """A 16-bit q over f32 pages, through the block table and the ragged
    meta: each launch takes the split walk, within the 16-bit tolerance
    of the plain version, a second launch bitwise the first."""
    h, hkv, d = geom
    rs = np.random.RandomState(8)
    page, pps = 16, 32
    b = len(F32_PAGE_CTX)
    num_pages = b * pps + 1
    q = torch.from_numpy(rs.randn(b, h, d).astype(np.float32)).to(cuda,
                                                                  dtype)
    kp, vp = (torch.from_numpy(rs.randn(num_pages, page, hkv, d).astype(
        np.float32)).to(cuda) for _ in range(2))
    tables = rs.permutation(num_pages)[:b * pps].reshape(b, pps).astype(
        np.int32)
    lens = np.asarray(F32_PAGE_CTX, np.int32)
    builder = RaggedMetaBuilder(b, pps, page, trash_page=0)
    for s, n in enumerate(lens):
        builder.set_slot(s, tables[s], min(int(n), pps * page))
    meta = torch.from_numpy(builder.stacked()).to(cuda)
    bt, cl = torch.from_numpy(tables).to(cuda), torch.from_numpy(lens).to(cuda)
    ragged_cl = cl.clamp(max=pps * page)
    for name, fn, plain in (
            ("paged_decode",
             lambda: P.paged_attention_kernel(q, kp, vp, bt, cl, 0.1),
             lambda: P.paged_attention_plain(q, kp, vp, bt, cl, 0.1)),
            ("ragged_decode",
             lambda: P.paged_attention_ragged_kernel(q, kp, vp, ragged_cl,
                                                     meta, 0.1),
             lambda: P.paged_attention_ragged_plain(q, kp, vp, ragged_cl,
                                                    meta, 0.1))):
        reset_launch_counts()
        out = fn()
        assert dict(route_counts) == {(name, "split"): 1}
        assert out.dtype == dtype
        torch.testing.assert_close(out.float(), plain().float(),
                                   **CARD_TOL[dtype])
        assert torch.equal(out, fn())
