"""The port's ragged paged-attention modules against the JAX reference.

Host metadata (``build_ragged_meta``, ``RaggedMetaBuilder``) must give
the reference's arrays; the plain ``paged_attention_ragged`` and the
plain variable-query versions are held against the reference's XLA path
and its Pallas kernels in interpret mode on the same seeded numpy inputs
(f32, atol = rtol = 1e-5: the same algorithm summed in another order).
The mixed-step cache contract must write only real span positions.

The ``cuda`` cases hold ``csrc/ragged_decode.cu`` and
``csrc/paged_varq.cu`` against their plain versions on the card
(``chip_smoke.py``'s tolerances) and skip without one; they import no
JAX, so ``python -m pytest --noconftest -m cuda tests/test_torch_ragged.py``
runs them where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.generation.kv_cache import (
    PagedCacheEntry, paged_cache_mixed_update_attend, span_index)
from paddle_tpu_torch.kernels.paged_attention import (
    RaggedMetaBuilder, build_ragged_meta, paged_attention_ragged,
    paged_attention_ragged_kernel, paged_attention_ragged_plain,
    paged_attention_ragged_varq, paged_attention_ragged_varq_plain,
    paged_attention_varq, paged_attention_varq_kernel,
    paged_attention_varq_plain)
from test_torch_kernels import CARD_DTYPES, _dtypes

TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = RaggedMetaBuilder.FIELDS


@pytest.fixture()
def interpret():
    """The reference's Pallas kernels in interpret mode (flags restored
    afterwards), as tests/test_mixed_step.py runs them."""
    from paddle_tpu.framework.flags import get_flags, set_flags
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        yield
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


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _m(meta, dev="cpu"):
    """The reference's dict of six meta arrays as the port's int32
    [6, G] tensor."""
    return torch.from_numpy(np.stack([meta[k] for k in FIELDS])).to(dev)


# --------------------------------------------------------- host metadata --

def _same_meta(got, want):
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == np.int32


@pytest.mark.parametrize("lens,bucket", [([12, 4], None), ([12, 12], None),
                                         ([12, 4], 16), ([0, 5], None)])
def test_build_ragged_meta_equals_reference(lens, bucket):
    from paddle_tpu.kernels.paged_attention import build_ragged_meta as ref
    tables = np.asarray([[0, 1, 2], [3, 9, 9]], np.int32)
    _same_meta(build_ragged_meta(tables, lens, 4, bucket),
               ref(tables, lens, 4, bucket))


def test_build_ragged_meta_bucket_overflow_raises():
    tables = np.asarray([[0, 1, 2], [3, 9, 9]], np.int32)
    with pytest.raises(ValueError, match="exceed"):
        build_ragged_meta(tables, [12, 12], 4, bucket_to=4)


def test_meta_builder_equals_reference_through_its_life():
    """set, advance (across page boundaries up to a full table),
    rollback and clear give the reference builder's arrays at every
    step; a rollback equals a fresh set_slot."""
    from paddle_tpu.kernels.paged_attention import RaggedMetaBuilder as Ref
    page, pps, trash = 4, 3, 9
    port, ref = RaggedMetaBuilder(2, pps, page, trash), Ref(2, pps, page,
                                                           trash)
    rows = [np.asarray([1, 2, 3], np.int32), np.asarray([4, 9, 9], np.int32)]
    ops = [("clear_slot", 0), ("clear_slot", 1), ("set_slot", 0, rows[0], 5),
           ("set_slot", 1, rows[1], 2), ("advance_slot", 0, 8),
           ("advance_slot", 0, 9), ("advance_slot", 1, 3),
           ("advance_slot", 0, 12), ("rollback_slot", 0, 6),
           ("advance_slot", 0, 11), ("clear_slot", 1),
           ("set_slot", 1, rows[0], 12)]
    for op, *args in ops:
        getattr(port, op)(*args)
        getattr(ref, op)(*args)
        _same_meta(port.meta(), ref.meta())
    np.testing.assert_array_equal(
        port.stacked(), np.stack([ref.meta()[k] for k in FIELDS]))
    a, b = RaggedMetaBuilder(2, 4, 8, 0), RaggedMetaBuilder(2, 4, 8, 0)
    row = np.asarray([3, 5, 7, 9], np.int32)
    a.set_slot(1, row, 9)
    a.advance_slot(1, 9 + 5)              # optimistic span advance
    a.rollback_slot(1, 11)
    b.set_slot(1, row, 11)
    _same_meta(a.meta(), b.meta())


def test_entries_take_only_the_stacked_meta():
    """The entries take the int32 [6, G] tensor (rows FIELDS) and refuse
    the reference's dict and any other shape."""
    m = build_ragged_meta(np.asarray([[0, 1]], np.int32), [5], 4)
    t = _m(m)
    assert t.dtype == torch.int32 and t.shape == (6, 8)
    q, kp = torch.randn(1, 2, 64), torch.randn(3, 4, 2, 64)
    lens = torch.tensor([5], dtype=torch.int32)
    assert paged_attention_ragged(q, kp, kp, lens, t).shape == (1, 2, 64)
    for bad in (m, t[:5], t[:, :0]):
        with pytest.raises(ValueError, match="6, G"):
            paged_attention_ragged(q, kp, kp, lens, bad)
        with pytest.raises(ValueError, match="6, G"):
            paged_attention_ragged_varq(q[:, None], kp, kp, lens, lens, bad)


# ------------------------------------------------------ ragged decode --

def _pool(rs, h, hkv, d, page=8, pps=6, b=3):
    p = b * pps + 1
    kp = (rs.randn(p, page, hkv, d) * 0.3).astype(np.float32)
    vp = (rs.randn(p, page, hkv, d) * 0.3).astype(np.float32)
    tables = np.full((b, pps), p - 1, np.int32)
    tables[0, :4] = [0, 1, 2, 3]
    tables[1, :2] = [4, 5]
    tables[2, :3] = [6, 7, 8]
    return kp, vp, tables


def _builder_meta(tables, post_lens, page):
    b, pps = tables.shape
    builder = RaggedMetaBuilder(b, pps, page, trash_page=int(tables.max()))
    for s in range(b):
        builder.set_slot(s, tables[s], int(post_lens[s]))
    return builder.meta()


def _interleaved_meta(tables, lens, page):
    """Each sequence's entries in reverse sequence order, with padding
    entries (valid == 0, aliasing live pages and other sequences)
    between and inside the sequences' ranges: a layout the reference's
    sequential kernel accepts that no builder produces."""
    meta = {k: [] for k in FIELDS}

    def add(seq, page_id, ordinal, first, last, valid):
        for k, x in zip(FIELDS, (seq, page_id, ordinal, first, last, valid)):
            meta[k].append(x)
    for s in reversed(range(len(lens))):
        n = -(-int(lens[s]) // page)
        add((s + 1) % len(lens), int(tables[0, 0]), 0, 0, 0, 0)
        for o in range(n):
            add(s, int(tables[s, o]), o, int(o == 0), int(o == n - 1), 1)
            if o == 0 and n > 1:        # padding inside the range
                add(s, int(tables[s, 1]), 1, 0, 0, 0)
    return {k: np.asarray(v, np.int32) for k, v in meta.items()}


@pytest.mark.parametrize("layout", ["builder", "compact"])
def test_ragged_plain_matches_reference(interpret, layout):
    """H = Hkv = 8, D = 128 (the Pallas kernel's geometry): the plain
    version against the interpret-mode `_ragged_kernel` and against the
    reference's XLA block-table path on the same lengths."""
    from paddle_tpu.kernels.paged_attention import (
        _paged_attention_xla, paged_attention_ragged as ref_ragged)
    rs = np.random.RandomState(0)
    kp, vp, tables = _pool(rs, 8, 8, 128)
    q = (rs.randn(3, 8, 128) * 0.3).astype(np.float32)
    lens = np.asarray([30, 9, 17], np.int32)
    meta = (_builder_meta(tables, lens, 8) if layout == "builder"
            else build_ragged_meta(tables, lens, 8, bucket_to=24))
    got = paged_attention_ragged(*_t(q, kp, vp, lens), _m(meta)).numpy()
    pallas = np.asarray(ref_ragged(_j(q), _j(kp), _j(vp), lens, meta))
    xla = np.asarray(_paged_attention_xla(_j(q), _j(kp), _j(vp),
                                          _j(tables), _j(lens),
                                          128 ** -0.5))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


@pytest.mark.parametrize("h,hkv,d", [(8, 2, 64), (4, 1, 128)])
def test_ragged_plain_gqa_matches_reference_xla(h, hkv, d):
    """GQA (the Pallas kernel takes H == Hkv only; the port takes any
    ratio): against the reference's XLA block-table path."""
    from paddle_tpu.kernels.paged_attention import _paged_attention_xla
    rs = np.random.RandomState(1)
    kp, vp, tables = _pool(rs, h, hkv, d)
    q = rs.randn(3, h, d).astype(np.float32)
    lens = np.asarray([32, 1, 24], np.int32)
    got = paged_attention_ragged(*_t(q, kp, vp, lens),
                                 _m(_builder_meta(tables, lens, 8))).numpy()
    want = np.asarray(_paged_attention_xla(_j(q), _j(kp), _j(vp),
                                           _j(tables), _j(lens), d ** -0.5))
    np.testing.assert_allclose(got, want, **TOL)


def test_ragged_plain_zero_rows_and_padding_entries(interpret):
    """context_lens == 0 gives zeros; padding entries (valid == 0) that
    alias live pages contribute nothing."""
    from paddle_tpu.kernels.paged_attention import (
        paged_attention_ragged as ref_ragged)
    rs = np.random.RandomState(2)
    kp, vp, tables = _pool(rs, 8, 8, 128)
    q = rs.randn(3, 8, 128).astype(np.float32)
    lens = np.asarray([0, 9, 3], np.int32)
    meta = build_ragged_meta(tables, lens, 8, bucket_to=16)
    got = paged_attention_ragged(*_t(q, kp, vp, lens), _m(meta)).numpy()
    assert not got[0].any()
    np.testing.assert_allclose(
        got, np.asarray(ref_ragged(_j(q), _j(kp), _j(vp), lens, meta)),
        **TOL)


@pytest.mark.parametrize("lens", [[30, 0, 17], [17, 9, 1]])
def test_ragged_plain_interleaved_meta_matches_reference(interpret, lens):
    """Sequences in reverse order with padding entries between and inside
    their ranges (the card kernel walks a sequence's range and skips
    them), and sequences whose one valid key opens their last page:
    against the interpret-mode `_ragged_kernel` and the XLA block-table
    path."""
    from paddle_tpu.kernels.paged_attention import (
        _paged_attention_xla, paged_attention_ragged as ref_ragged)
    rs = np.random.RandomState(9)
    kp, vp, tables = _pool(rs, 8, 8, 128)
    q = (rs.randn(3, 8, 128) * 0.3).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    meta = _interleaved_meta(tables, lens, 8)
    got = paged_attention_ragged(*_t(q, kp, vp, lens), _m(meta)).numpy()
    pallas = np.asarray(ref_ragged(_j(q), _j(kp), _j(vp), lens, meta))
    xla = np.asarray(_paged_attention_xla(_j(q), _j(kp), _j(vp),
                                          _j(tables), _j(lens),
                                          128 ** -0.5))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got[lens > 0], xla[lens > 0], **TOL)
    assert not got[lens == 0].any()


# ------------------------------------------------------- varq (spans) --

# the spans of tests/test_mixed_step.py: a 2-page chunk, a decode token
# and a mid-page chunk
SPANS = dict(kv_lens=np.asarray([30, 9, 17], np.int32),
             q_lens=np.asarray([16, 1, 5], np.int32), qb=16)


def _varq_case(rs, h, hkv, d):
    kp, vp, tables = _pool(rs, h, hkv, d)
    q = (rs.randn(3, SPANS["qb"], h, d) * 0.3).astype(np.float32)
    return q, kp, vp, tables


def test_varq_plain_matches_reference(interpret):
    from paddle_tpu.kernels.paged_attention import (
        _paged_attention_varq_xla, paged_attention_ragged_varq as ref_rv)
    rs = np.random.RandomState(0)
    q, kp, vp, tables = _varq_case(rs, 8, 8, 128)
    kl, ql = SPANS["kv_lens"], SPANS["q_lens"]
    meta = build_ragged_meta(tables, kl, 8, bucket_to=24)
    xla = np.asarray(_paged_attention_varq_xla(
        _j(q), _j(kp), _j(vp), _j(tables), kl, ql, 128 ** -0.5))
    pallas = np.asarray(ref_rv(_j(q), _j(kp), _j(vp), kl, ql, meta))
    by_table = paged_attention_varq(*_t(q, kp, vp, tables, kl, ql)).numpy()
    by_meta = paged_attention_ragged_varq(*_t(q, kp, vp, kl, ql),
                                          _m(meta)).numpy()
    for got in (by_table, by_meta):
        np.testing.assert_allclose(got, xla, **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
    # padding query rows are exactly zero
    assert not by_table[1, 1:].any() and not by_table[2, 5:].any()
    assert not by_meta[1, 1:].any() and not by_meta[2, 5:].any()


def test_varq_plain_gqa_matches_reference_xla():
    from paddle_tpu.kernels.paged_attention import _paged_attention_varq_xla
    rs = np.random.RandomState(3)
    q, kp, vp, tables = _varq_case(rs, 8, 2, 64)
    kl, ql = SPANS["kv_lens"], SPANS["q_lens"]
    want = np.asarray(_paged_attention_varq_xla(
        _j(q), _j(kp), _j(vp), _j(tables), kl, ql, 64 ** -0.5))
    got = paged_attention_varq(*_t(q, kp, vp, tables, kl, ql)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    meta = _m(_builder_meta(tables, kl, 8))
    got_m = paged_attention_ragged_varq(*_t(q, kp, vp, kl, ql), meta).numpy()
    np.testing.assert_allclose(got_m, want, **TOL)


@pytest.mark.parametrize("source", ["table", "meta"])
def test_varq_plain_long_spans_match_reference_xla(source):
    """The card tests' span shapes at a small width: a span crossing
    64-row query tiles whose first key tile is partial, a short chunk, a
    decode row; GQA 2, head_dim 64."""
    from paddle_tpu.kernels.paged_attention import _paged_attention_varq_xla
    rs = np.random.RandomState(10)
    kp, vp, tables = _pool(rs, 4, 2, 64, pps=16)
    tables[:] = rs.permutation(kp.shape[0])[:tables.size].reshape(
        tables.shape)
    q = (rs.randn(3, 80, 4, 64) * 0.3).astype(np.float32)
    kl = np.asarray([107, 60, 33], np.int32)
    ql = np.asarray([70, 5, 1], np.int32)
    want = np.asarray(_paged_attention_varq_xla(
        _j(q), _j(kp), _j(vp), _j(tables), kl, ql, 64 ** -0.5))
    if source == "table":
        got = paged_attention_varq(*_t(q, kp, vp, tables, kl, ql)).numpy()
    else:
        got = paged_attention_ragged_varq(
            *_t(q, kp, vp, kl, ql), _m(_builder_meta(tables, kl, 8))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0, 70:].any() and not got[1, 5:].any()


def test_varq_single_token_spans_equal_ragged_decode():
    """q_lens == 1 everywhere degenerates to decode attention."""
    rs = np.random.RandomState(4)
    q, kp, vp, tables = _varq_case(rs, 8, 8, 128)
    kl = SPANS["kv_lens"]
    ones = np.ones(3, np.int32)
    meta = _m(_builder_meta(tables, kl, 8))
    dec = paged_attention_ragged(*_t(q[:, 0], kp, vp, kl), meta).numpy()
    span = paged_attention_ragged_varq(*_t(q[:, :1], kp, vp, kl, ones),
                                       meta).numpy()
    np.testing.assert_allclose(span[:, 0], dec, **TOL)


def test_mixed_update_writes_only_real_positions():
    """A slot with a FULLY-allocated block table whose padding span
    positions run past the table's end: the one real write lands at
    position 30 and nothing else in the pool changes (padding positions
    are not selected, so they never clamp into the last real page)."""
    B, page, pps, H, D = 1, 8, 4, 4, 16
    kp = torch.zeros(pps, page, H, D)
    vp = torch.zeros(pps, page, H, D)
    bt = torch.arange(pps, dtype=torch.int32)[None, :]
    cl = torch.tensor([30], dtype=torch.int32)
    ql = torch.tensor([1], dtype=torch.int32)
    qb = 16
    rs = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rs.randn(B, qb, H, D).astype(np.float32))
               for _ in range(3))
    entry = PagedCacheEntry(kp, vp, bt, cl, span_index(bt, cl, ql, page),
                            None, ql)
    out, _ = paged_cache_mixed_update_attend(entry, q, k, v)
    assert torch.equal(kp[3, 6], k[0, 0]) and torch.equal(vp[3, 6], v[0, 0])
    mask = torch.ones(pps, page, dtype=torch.bool)
    mask[3, 6] = False
    assert not kp[mask].any() and not vp[mask].any()
    assert not out[0, 1:].any()           # padding rows read back zeros


def test_span_index_lists_real_positions():
    bt = torch.tensor([[5, 6, 7], [1, 2, 3]], dtype=torch.int32)
    s = span_index(bt, torch.tensor([6, 0]), torch.tensor([3, 2]), 4)
    assert s.rows.tolist() == [[0, 0, 0, 1, 1], [0, 1, 2, 0, 1],
                               [6, 6, 7, 1, 1], [2, 3, 0, 0, 1]]
    assert s.kv_lens.tolist() == [9, 2] and s.kv_lens.dtype == torch.int32


def test_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 2, 64)
    kp = torch.randn(3, 4, 2, 64)
    lens = torch.tensor([5], dtype=torch.int32)
    meta = _m(build_ragged_meta(np.asarray([[0, 1]]), [5], 4))
    with pytest.raises(ValueError):
        paged_attention_ragged_kernel(q, kp, kp, lens, meta, 0.125)
    with pytest.raises(ValueError):
        paged_attention_varq_kernel(q[:, None], kp, kp, lens, lens, 0.125,
                                    meta=meta)
    with pytest.raises(ValueError, match="exactly one"):
        paged_attention_varq_kernel(q[:, None], kp, kp, lens, lens, 0.125)


# ------------------------------------------------------------ on the card --

# the card tolerances are test_torch_kernels.py's (chip_smoke.py's TOL):
# f32 sums in another order; bf16 and f16 outputs rounded at other places
# (and P rounded before P.V in the varq plain version only); q of one
# dtype and pages of another take the narrower dtype's (``_dtypes``)


# GQA groups 1, 4 and 8 at head_dim 64 and 128
CARD_GEOMS = [(8, 8, 128), (8, 8, 64), (8, 2, 64), (32, 8, 128), (32, 4, 64),
              (32, 4, 128)]


def _card_pool(rs, h, hkv, d, dtype, dev, page=8, pps=6, b=3):
    """A pool of b * pps + 1 pages and b shuffled block-table rows."""
    p = b * pps + 1
    kp, vp = ((rs.randn(p, page, hkv, d) * 0.3).astype(np.float32)
              for _ in range(2))
    tables = rs.permutation(p)[:b * pps].reshape(b, pps).astype(np.int32)
    return (torch.from_numpy(kp).to(dev, dtype),
            torch.from_numpy(vp).to(dev, dtype), tables)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("h,hkv,d", CARD_GEOMS)
def test_ragged_kernel_matches_plain(cuda, dtype, page, h, hkv, d):
    """Contexts over several cluster ranks ending mid-page, a zero row,
    a sequence whose one valid key opens its last page, and a single key;
    builder, compact-bucketed and interleaved metas; a second launch is
    bitwise the first. Mixed entries: q of one dtype, pages of another."""
    qd, kd, tol = _dtypes(dtype)
    rs = np.random.RandomState(5)
    kp, vp, tables = _card_pool(rs, h, hkv, d, kd, cuda, page, 48, 4)
    q = torch.from_numpy(rs.randn(4, h, d).astype(np.float32)).to(cuda, qd)
    lens = np.asarray([323, 0, 2 * page + 1, 1], np.int32)
    cl = torch.from_numpy(lens).to(cuda)
    for meta in (_builder_meta(tables, lens, page),
                 build_ragged_meta(tables, lens, page, bucket_to=64),
                 _interleaved_meta(tables, lens, page)):
        m = _m(meta, cuda)
        got = paged_attention_ragged_kernel(q, kp, vp, cl, m, 0.1)
        want = paged_attention_ragged_plain(q, kp, vp, cl, m, 0.1)
        assert got.dtype == qd
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert not got[1].any()
        assert torch.equal(paged_attention_ragged_kernel(q, kp, vp, cl, m,
                                                         0.1), got)


def _varq_card_check(q, kp, vp, kl, ql, tables, page, tol):
    """The kernel against its plain version through the block table and
    through the meta, padding rows zero, a second launch bitwise equal;
    returns the meta."""
    bt = torch.from_numpy(tables).to(q.device)
    m = _m(_builder_meta(tables, kl.cpu().numpy(), page), q.device)
    pad = torch.arange(q.shape[1], device=q.device)[None] >= ql[:, None]
    for src, plain in ((dict(block_tables=bt),
                        lambda: paged_attention_varq_plain(q, kp, vp, bt, kl,
                                                           ql, 0.1)),
                       (dict(meta=m),
                        lambda: paged_attention_ragged_varq_plain(
                            q, kp, vp, kl, ql, m, 0.1))):
        got = paged_attention_varq_kernel(q, kp, vp, kl, ql, 0.1, **src)
        assert got.dtype == q.dtype
        torch.testing.assert_close(got.float(), plain().float(), **tol)
        assert not got[pad].any() and not got[kl <= 0].any()
        assert torch.equal(
            paged_attention_varq_kernel(q, kp, vp, kl, ql, 0.1, **src), got)
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", CARD_DTYPES)
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("h,hkv,d", CARD_GEOMS)
def test_varq_kernel_matches_plain(cuda, dtype, page, h, hkv, d):
    """Mixed spans (one crossing 64-row tiles and starting mid key tile,
    a short chunk, a decode row, a kv_lens == 0 slot), then 5-row verify
    spans (one query tile per slot: the cluster-split walk), then
    single-token spans against the ragged decode kernel. Mixed entries:
    q of one dtype, pages of another."""
    qd, kd, tol = _dtypes(dtype)
    rs = np.random.RandomState(6)
    kp, vp, tables = _card_pool(rs, h, hkv, d, kd, cuda, page, 48, 4)

    def span_case(qb, q_lens, kv_lens):
        q = torch.from_numpy(rs.randn(4, qb, h, d).astype(np.float32)).to(
            cuda, qd)
        kl, ql = (torch.tensor(x, dtype=torch.int32, device=cuda)
                  for x in (kv_lens, q_lens))
        return q, kl, ql, _varq_card_check(q, kp, vp, kl, ql, tables, page,
                                           tol)
    span_case(96, [80, 20, 1, 3], [117, 83, 130, 0])
    q, kl, _, m = span_case(5, [5, 5, 5, 5], [301, 150, 37, 5])
    ones = torch.ones_like(kl)
    dec = paged_attention_ragged_kernel(q[:, 0].contiguous(), kp, vp, kl, m,
                                        0.1)
    span = paged_attention_varq_kernel(q[:, :1].contiguous(), kp, vp, kl,
                                       ones, 0.1, meta=m)
    torch.testing.assert_close(span[:, 0].float(), dec.float(), **tol)
