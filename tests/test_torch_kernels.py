"""The port's kernel modules against the JAX reference.

On the CPU each wrapper takes its plain PyTorch version; those are held
against the reference functions on the same seeded numpy inputs, through
the reference's XLA path and, where its gate admits the shape, through
its Pallas kernels in interpret mode. f32 tolerance: atol = rtol = 1e-5
(the same algorithm summed in another order).

The ``cuda`` cases hold each hand-written kernel against its plain
version on the card and skip without one. The JAX side is imported
inside the CPU cases only, so the CUDA cases also run where JAX is not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.attention import (additive_mask,
                                                flash_attention_bshd,
                                                flash_attention_kernel,
                                                flash_attention_plain)
from paddle_tpu_torch.kernels.norm import (fused_layer_norm, fused_rms_norm,
                                           rms_norm_kernel, rms_norm_plain)
from paddle_tpu_torch.kernels.paged_attention import (
    RaggedMetaBuilder, paged_attention, paged_attention_kernel,
    paged_attention_plain, paged_attention_ragged,
    paged_attention_ragged_varq, paged_attention_varq)

TOL = dict(atol=1e-5, rtol=1e-5)
NEG = -1e30


@pytest.fixture(params=[False, True], ids=["xla", "pallas_interpret"])
def ref_mode(request):
    """Run the reference through its XLA path, or through its Pallas
    kernels in interpret mode (flags restored afterwards)."""
    from paddle_tpu.framework.flags import get_flags, set_flags
    if not request.param:
        yield "xla"
        return
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        yield "pallas_interpret"
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _j(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


# ------------------------------------------------------------- RMSNorm --

@pytest.mark.parametrize("shape", [(6, 128), (2, 3, 256)])
def test_rms_norm_plain_matches_reference(ref_mode, shape):
    from paddle_tpu.kernels.norm import fused_rms_norm as ref_rms
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    want = np.asarray(ref_rms(_j(x), _j(w), 1e-6))
    got = fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------ flash forward --

def _prefill_mask(b, s, pads):
    """Additive [B, 1, S, S] causal + left-padding mask, as prefill
    builds it."""
    j = np.arange(s)
    key_valid = j[None, :] >= np.asarray(pads)[:, None]
    ok = key_valid[:, None, :] & (j[None, :] <= j[:, None])[None]
    return np.where(ok, 0.0, NEG).astype(np.float32)[:, None]


def _flash_case(name, rng):
    """(q, k, v, causal, mask, kv_lens, valid rows [B, Sq]) for a case."""
    b, h, d = 2, 4, 64
    mask, causal, lens = None, False, None
    if name == "tile_edge_130":                   # one row past 64 and 128
        sq = sk = 130
        hkv, d, causal = h, 128, True
    elif name == "suffix_mask_only":              # Sq < Sk, causal by mask
        sq, sk, hkv, d = 40, 130, h, 128
        j = np.arange(sk)[None, :] - (sk - sq)
        mask = np.where(j <= np.arange(sq)[:, None], 0.0, NEG)
        mask = mask.astype(np.float32)[None, None]
    elif name == "gqa4_d128":
        h, hkv, d, causal = 8, 2, 128, True
        sq = sk = 70
    elif name == "kv_lens_mid_tile":
        sq = sk = 130
        hkv, d, lens = h, 128, np.array([130, 70], np.int32)
    elif name == "dropout_key_mask":
        sq = sk = 130
        hkv = h
        mask = np.zeros((b, 1, 1, sk), np.float32)
        mask[1, ..., -50:] = NEG
    elif name == "no_valid_key":                  # whole rows masked out
        sq = sk = 72
        hkv, lens = h, np.array([72, 0], np.int32)
        mask = np.zeros((b, 1, sq, sk), np.float32)
        mask[0, :, [3, 40]] = NEG
    elif name == "causal_mask":
        sq = sk = 16
        hkv = h
        mask = _prefill_mask(b, sq, [0, 5])
        causal, lens = True, None
    elif name == "mask_sq_lt_sk":
        sq, sk, hkv = 8, 24, h
        mask = np.where(rng.rand(1, 1, sq, sk) < 0.3, NEG, 0.0)
        mask[..., -1] = 0.0                       # every row keeps a key
        mask = mask.astype(np.float32)
        causal, lens = False, None
    elif name == "gqa_causal_mask":
        sq = sk = 16
        hkv = 2
        mask = _prefill_mask(b, sq, [3, 0])
        causal, lens = True, None
    elif name == "gqa_key_padding_q1":
        sq = sk = 12
        hkv = 1
        mask = np.zeros((b, 1, 1, sk), np.float32)
        mask[1, ..., :4] = NEG
        causal, lens = False, None
    elif name == "kv_lens":
        sq = sk = 16
        hkv = h
        mask, causal, lens = None, True, np.array([16, 9], np.int32)
    else:
        raise ValueError(name)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, hkv, d).astype(np.float32)
    v = rng.randn(b, sk, hkv, d).astype(np.float32)
    # rows with at least one valid key (fully masked padding rows are
    # implementation-defined in both packages)
    s = np.zeros((b, 1, sq, sk), np.float32)
    if mask is not None:
        s = s + mask
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(sk)[None, :], s, NEG)
    if lens is not None:
        s = np.where(np.arange(sk)[None, None, None, :]
                     < lens[:, None, None, None], s, NEG)
    valid = (s > NEG / 2).any(-1)[:, 0]           # [B, Sq]
    return q, k, v, causal, mask, lens, valid


FLASH_CASES = ["causal_mask", "mask_sq_lt_sk", "gqa_causal_mask",
               "gqa_key_padding_q1", "kv_lens"]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_reference(ref_mode, case):
    from paddle_tpu.kernels.attention import flash_attention_jax
    rng = np.random.RandomState(1)
    q, k, v, causal, mask, lens, valid = _flash_case(case, rng)
    want = np.asarray(flash_attention_jax(
        _j(q), _j(k), _j(v), causal=causal,
        mask=None if mask is None else _j(mask),
        kv_lens=None if lens is None else _j(lens)))
    got = flash_attention_bshd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal, kv_lens=lens).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_flash_bool_mask_equals_additive():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 2, 64).astype(np.float32))
               for _ in range(3))
    keep = torch.from_numpy(rng.rand(1, 1, 8, 8) < 0.7)
    keep[..., 0] = True
    add = torch.where(keep, 0.0, NEG)
    torch.testing.assert_close(
        flash_attention_bshd(q, k, v, attn_mask=keep),
        flash_attention_bshd(q, k, v, attn_mask=add), atol=0, rtol=0)


def test_flash_rejects_dropout_and_bad_mask():
    """Dropout outside [0, 1) and a mask that does not broadcast raise
    (dropout in [0, 1) runs: ``test_torch_attn_dropout.py``)."""
    q = torch.zeros(1, 8, 2, 64)
    for p in (1.0, 1.5, -0.1):
        with pytest.raises(ValueError):
            flash_attention_bshd(q, q, q, dropout_p=p, training=True)
    with pytest.raises(ValueError):
        additive_mask(torch.zeros(3, 1, 8, 8), 1, 2, 8, 8)


# --------------------------------------------------------- paged decode --

def _paged_case(rng, h, hkv, d, lens, page=4, pps=4, num_pages=14):
    b = len(lens)
    q = rng.randn(b, h, d).astype(np.float32)
    kp = rng.randn(num_pages, page, hkv, d).astype(np.float32)
    vp = rng.randn(num_pages, page, hkv, d).astype(np.float32)
    tables = rng.permutation(num_pages)[:b * pps].reshape(b, pps)
    return q, kp, vp, tables.astype(np.int32), np.asarray(lens, np.int32)


@pytest.mark.parametrize("h,hkv,d", [(8, 8, 128), (4, 2, 64), (8, 1, 128)],
                         ids=["mha", "gqa", "mqa"])
def test_paged_plain_matches_reference(ref_mode, h, hkv, d):
    """Mixed context lengths (a partial last page, a full table, one
    token, and a length past the table, where both reference paths
    attend to the keys the table names); held to context_lens >= 1, the
    only rows decode produces."""
    from paddle_tpu.kernels.paged_attention import paged_attention as ref
    rng = np.random.RandomState(3)
    q, kp, vp, tables, lens = _paged_case(rng, h, hkv, d, [5, 16, 1, 23],
                                          num_pages=20)
    want = np.asarray(ref(_j(q), _j(kp), _j(vp), _j(tables), _j(lens),
                          interpret=ref_mode == "pallas_interpret"))
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, kp, vp, tables, lens))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_zero_context_rows_are_zero():
    """context_lens == 0 gives zero rows, as the Pallas kernel writes
    them (the reference's XLA path averages V uniformly there instead —
    the decode step never asks for such a row)."""
    from paddle_tpu.kernels.paged_attention import paged_attention as ref
    rng = np.random.RandomState(4)
    q, kp, vp, tables, lens = _paged_case(rng, 8, 8, 128, [0, 7, 0])
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, kp, vp, tables, lens))).numpy()
    assert not got[[0, 2]].any()
    pallas = np.asarray(ref(_j(q), _j(kp), _j(vp), _j(tables), _j(lens),
                            interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


# ------------------------------------------- wrappers on the CPU / CUDA --

def test_cpu_tensors_take_plain_versions():
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    x = torch.randn(4, 64)
    fused_rms_norm(x, torch.ones(64))
    q = torch.randn(1, 8, 2, 64)
    flash_attention_bshd(q, q, q, is_causal=True)
    kp = torch.randn(3, 4, 2, 64)
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    lens = torch.tensor([5], dtype=torch.int32)
    paged_attention(torch.randn(1, 2, 64), kp, kp, tables, lens)
    builder = RaggedMetaBuilder(1, 2, 4)
    builder.set_slot(0, tables[0].numpy(), 5)
    meta = torch.from_numpy(builder.stacked())
    paged_attention_ragged(torch.randn(1, 2, 64), kp, kp, lens, meta)
    q = torch.randn(1, 3, 2, 64)
    ql = torch.tensor([3], dtype=torch.int32)
    paged_attention_varq(q, kp, kp, tables, lens, ql)
    paged_attention_ragged_varq(q, kp, kp, lens, ql, meta)
    fused_layer_norm(x, torch.ones(64), torch.zeros(64))
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    w = torch.nn.Parameter(torch.randn(5, 3))
    w.grad = torch.randn(5, 3)
    opt = AdamW(parameters=[w], grad_clip=ClipGradByGlobalNorm(1.0))
    opt.step()
    assert opt._fused_plan is not None
    from paddle_tpu_torch.kernels.sampling import (categorical_rows,
                                                   uniform64_rows)
    ints = torch.arange(4, dtype=torch.int32)
    categorical_rows(torch.randn(4, 64), ints, ints, ints)
    uniform64_rows(ints, ints, ints)
    assert launch_counts == {"rms_norm": 0, "layer_norm": 0, "flash_fwd": 0,
                             "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                             "paged_decode": 0, "ragged_decode": 0,
                             "paged_varq": 0, "fused_update": 0,
                             "grad_sq_norm": 0, "categorical_rows": 0,
                             "uniform64_rows": 0}


def test_library_path_follows_headers(tmp_path, monkeypatch):
    """A header edit renames every library (each source may include it),
    a source edit only its own: a stale library is never loaded."""
    import shutil
    from paddle_tpu_torch.kernels import _build
    for f in _build.SRC_DIR.iterdir():
        shutil.copy(f, tmp_path)
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    names = sorted(f.stem for f in tmp_path.glob("*.cu"))
    headers = sorted(tmp_path.glob("*.cuh"))
    assert "flash_fwd" in names and len(headers) >= 2
    after = {n: _build.library_path(n) for n in names}
    assert after == {n: _build.library_path(n) for n in names}
    for hdr in headers:                 # wgmma.cuh, decode_split.cuh
        before = after
        hdr.write_text(hdr.read_text() + "\n// edited\n")
        after = {n: _build.library_path(n) for n in names}
        assert all(after[n] != before[n] for n in names), hdr.name
    src = tmp_path / "paged_decode.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {n: _build.library_path(n) for n in names}
    assert [n for n in names if again[n] != after[n]] == ["paged_decode"]


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError):
        flash_attention_kernel(*(torch.randn(1, 8, 2, 64),) * 3, 0.125)
    with pytest.raises(ValueError):
        paged_attention_kernel(
            torch.randn(1, 2, 64), torch.randn(3, 4, 2, 64),
            torch.randn(3, 4, 2, 64),
            torch.tensor([[0, 1]], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32), 0.125)
    with pytest.raises(TypeError):
        rms_norm_kernel(x.double(), torch.ones(64, dtype=torch.float64), 1e-6)


# bf16 tolerance on the card: the kernel and its plain version round the
# output to bf16 at different places, one bf16 ulp apart at most (2^-7
# relative: rtol); atol covers small outputs, where the largest error
# measured at serving shapes is 3.9e-3. f16 keeps 3 more bits (2^-10
# relative): the bf16 tolerance over 5 (rtol 4e-3, atol 1e-3)
CARD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=5e-3, rtol=2e-2),
            torch.float16: dict(atol=1e-3, rtol=4e-3)}
# q (and the output) of one dtype, K/V or pages of another: the FMA
# instances; held to the narrower dtype's tolerance (P is rounded to the
# pages' dtype before P.V, the output to q's)
MIXED = [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
         (torch.float16, torch.float32), (torch.float32, torch.float16),
         (torch.bfloat16, torch.float16), (torch.float16, torch.bfloat16)]
CARD_DTYPES = [torch.float32, torch.bfloat16, torch.float16, *MIXED]
_WIDTH = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _dtypes(dtype):
    """(q dtype, K/V dtype, tolerance) of a ``CARD_DTYPES`` entry."""
    qd, kd = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    return qd, kd, CARD_TOL[max(qd, kd, key=_WIDTH.__getitem__)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_rms_norm_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(37, 4096, device=cuda, generator=g).to(dtype)
    w = torch.randn(4096, device=cuda, generator=g).to(dtype)
    torch.testing.assert_close(rms_norm_kernel(x, w, 1e-6),
                               rms_norm_plain(x, w, 1e-6), **CARD_TOL[dtype])


# the card cases add tile edges (64- and 128-row tiles), head_dim 128,
# GQA 4, kv_lens inside a tile, dropout and rows with no valid key
CARD_FLASH_CASES = FLASH_CASES + [
    "tile_edge_130", "suffix_mask_only", "gqa4_d128", "kv_lens_mid_tile",
    "dropout_key_mask", "no_valid_key"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("case", CARD_FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    """Output on the rows with a valid key within the card tolerance, lse
    there within the f32 one (scores are f32 in every dtype), lse exactly
    -1e30 on rows with none (the backward kernels rebuild P from it), and
    a second launch bitwise equal to the first. q and K/V of different
    dtypes refuse dropout."""
    qd, kd, tol = _dtypes(dtype)
    rng = np.random.RandomState(5)
    q, k, v, causal, mask, lens, valid = _flash_case(case, rng)
    q = torch.from_numpy(q).to(cuda, qd)
    k, v = (torch.from_numpy(a).to(cuda, kd) for a in (k, v))
    m = None if mask is None else torch.from_numpy(mask).to(cuda)
    kl = None if lens is None else torch.from_numpy(lens).to(cuda)
    drop = dict(dropout_p=0.1, seeds=(-5, 2 ** 31 - 3)) \
        if case == "dropout_key_mask" else {}
    args = (q, k, v, 0.125, causal, m, kl)
    if drop and qd != kd:
        with pytest.raises(TypeError, match="dropout"):
            flash_attention_kernel(*args, **drop)
        return
    out, lse = flash_attention_kernel(*args, **drop)
    assert out.dtype == qd
    want, want_lse = flash_attention_plain(*args, return_lse=True, **drop)
    assert torch.isfinite(out.float()).all() and lse.shape == q.shape[:1] + (
        q.shape[2], q.shape[1])
    vm = torch.from_numpy(valid).to(cuda)
    torch.testing.assert_close(out[vm].float(), want[vm].float(), **tol)
    lse_rows = lse.transpose(1, 2)                # [B, Sq, H]
    torch.testing.assert_close(lse_rows[vm],
                               want_lse.transpose(1, 2)[vm],
                               **CARD_TOL[torch.float32])
    assert (lse_rows[~vm] == NEG).all()
    again = flash_attention_kernel(*args, **drop)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# (page, pages per sequence, context lengths, pages): a 16-token table (a
# cluster of one CTA in bf16), then a 512-token one split over 8 ranks in
# shares of ceil(ctx / 8) rounded up to 16 tokens: contexts 0, 1, 63-65,
# 127-129 (one share boundary per rank), pps * page and past it
PAGED_GEOMETRIES = [(4, 4, [5, 16, 1, 0, 23], 20),
                    (16, 32, [0, 1, 63, 64, 65, 127, 128, 129, 512, 600],
                     324)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("h,hkv,d", [(8, 8, 128), (4, 2, 64), (32, 8, 128),
                                     (4, 4, 64), (16, 4, 64), (8, 1, 64),
                                     (16, 2, 128)],
                         ids=["g1_d128", "g2_d64", "g4_d128", "g1_d64",
                              "g4_d64", "g8_d64", "g8_d128"])
def test_paged_kernel_matches_plain(cuda, dtype, h, hkv, d):
    """Each geometry within the card tolerance of the plain version, and
    a second launch bitwise equal to the first; q of one dtype, pages of
    another for the mixed entries."""
    qd, kd, tol = _dtypes(dtype)
    rng = np.random.RandomState(6)
    for page, pps, ctx, num_pages in PAGED_GEOMETRIES:
        arrs = _paged_case(rng, h, hkv, d, ctx, page=page, pps=pps,
                           num_pages=num_pages)
        q = torch.from_numpy(arrs[0]).to(cuda, qd)
        kp, vp = (torch.from_numpy(a).to(cuda, kd) for a in arrs[1:3])
        tables, lens = (torch.from_numpy(a).to(cuda) for a in arrs[3:])
        out = paged_attention_kernel(q, kp, vp, tables, lens, 0.1)
        assert out.dtype == qd
        torch.testing.assert_close(
            out.float(),
            paged_attention_plain(q, kp, vp, tables, lens, 0.1).float(),
            **tol)
        assert torch.equal(out, paged_attention_kernel(q, kp, vp, tables,
                                                       lens, 0.1))
