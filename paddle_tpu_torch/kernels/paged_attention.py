"""Paged-KV attention for serving: the decode kernels ``csrc/paged_decode.cu``
(block-table grid) and ``csrc/ragged_decode.cu`` (ragged work list), the
variable-query span kernel ``csrc/paged_varq.cu``, their plain PyTorch
versions, the entries, and the host-side ragged metadata (counterpart of
``paddle_tpu/kernels/paged_attention.py``: ``_paged_kernel``,
``_ragged_kernel``, ``_ragged_varq_kernel`` and their wrappers,
``build_ragged_meta``, ``RaggedMetaBuilder``).

The Pallas gate's limits (H == Hkv, D % 128, H % 8) are TPU tiling
artefacts and are not carried over: the kernels take any GQA ratio and
head_dim 64 or 128. A geometry a kernel refuses raises; nothing falls
back to the plain version on a CUDA tensor.

Ragged metadata travels as one int32 ``[6, G]`` tensor whose rows are
``RaggedMetaBuilder.FIELDS`` (seq, page, ordinal, first, last, valid).

Each kernel takes q and pages in float32, bfloat16 or float16, the pages
in the KV pool's dtype and q in the model's, which may differ (the C
entries take both dtype codes): one 16-bit dtype runs the tensor-core or
cluster-split instance, f32 or two dtypes the FMA instance. The plain
versions compute in f32 whatever the dtypes and return q's dtype.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ._build import NEG_INF, check, count_launch, load, stream_ptr

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "paged_decode": {"paged_decode": [
        _I, _I, _I,                         # dtype, kv_dtype, head_dim
        _P, _P, _P, _P, _P, _P,             # pointers
        _I, _I, _I, _I, _I, _I,             # B, H, Hkv, page, pps, pages
        ctypes.c_float, _P]},               # scale, stream
    "ragged_decode": {"ragged_decode": [
        _I, _I, _I,                          # dtype, kv_dtype, head_dim
        _P, _P, _P, _P, _P, _P, _P,          # pointers
        _I, _I, _I, _I, _I, _I,              # B, H, Hkv, page, pages, G
        ctypes.c_float, _P]},                # scale, stream
    "paged_varq": {"paged_varq": [
        _I, _I, _I,                              # dtype, kv_dtype, head_dim
        _P, _P, _P, _P, _P, _P, _P, _P,          # pointers
        _I, _I, _I, _I, _I, _I, _I, _I,          # B, Qb, H, Hkv, page,
        ctypes.c_float, _P]},                    # pps, pages, G; scale
}
# the largest query-head group paged_varq packs into its 64-row tile
_VARQ_MAX_GROUP = 64


# ------------------------------------------------------ ragged metadata --

def build_ragged_meta(block_tables, context_lens, page_size, bucket_to=None):
    """Flatten per-sequence page lists into ragged metadata.

    block_tables: [B, pages_per_seq] int (host); context_lens: [B] int
    (host). Returns a dict of int32 arrays of length G (bucketed): seq
    (owning sequence), page (physical page id), ordinal (page index
    within its sequence), first/last (1 at a sequence's first/last
    page), valid (0 on padding entries). Padding entries sit at the end
    and alias the last real entry's seq/page."""
    bt = np.asarray(block_tables)
    cl = np.asarray(context_lens)
    n_pages = np.where(cl > 0, -(-cl // page_size), 0).astype(np.int64)
    seqs_a = np.repeat(np.arange(bt.shape[0]), n_pages)
    ords_a = np.concatenate([np.arange(n) for n in n_pages]) \
        if len(n_pages) else np.zeros(0, np.int64)
    pages_a = bt[seqs_a, ords_a] if seqs_a.size else seqs_a
    firsts_a = (ords_a == 0).astype(np.int64)
    lasts_a = (ords_a == n_pages[seqs_a] - 1).astype(np.int64) \
        if seqs_a.size else seqs_a
    seqs, pages = seqs_a.tolist(), pages_a.tolist()
    ords, firsts, lasts = (ords_a.tolist(), firsts_a.tolist(),
                           lasts_a.tolist())
    g = len(seqs)
    if bucket_to is None:
        bucket_to = 8
        while bucket_to < g:
            bucket_to *= 2
    if g > bucket_to:
        raise ValueError(f"{g} page entries exceed bucket {bucket_to}")
    pad = bucket_to - g
    fill_seq = seqs[-1] if seqs else 0
    fill_page = pages[-1] if pages else 0

    def mk(xs, fill):
        return np.asarray(xs + [fill] * pad, np.int32)
    return {
        "seq": mk(seqs, fill_seq), "page": mk(pages, fill_page),
        "ordinal": mk(ords, 0),
        "first": mk(firsts, 0), "last": mk(lasts, 0),
        "valid": np.asarray([1] * g + [0] * pad, np.int32),
    }


class RaggedMetaBuilder:
    """Incrementally maintained ragged metadata for the serving loop.

    Each slot owns a FIXED row segment [b*pages_per_seq,
    (b+1)*pages_per_seq) of the flat arrays, so a decode step changes
    O(1) entries (a slot gains at most one page per token) and only
    admission/eviction rewrite a whole segment. A segment keeps its
    sequence's pages contiguous and in ordinal order; its padding rows
    alias the slot's last valid page with valid=0. The grid size is the
    constant B * pages_per_seq.
    """

    FIELDS = ("seq", "page", "ordinal", "first", "last", "valid")

    def __init__(self, n_slots, pages_per_seq, page_size, trash_page=0):
        self.B = int(n_slots)
        self.pps = int(pages_per_seq)
        self.page = int(page_size)
        self.trash = int(trash_page)
        G = self.B * self.pps
        self.seq = np.repeat(np.arange(self.B), self.pps).astype(np.int32)
        self.page_ids = np.full(G, trash_page, np.int32)
        self.ordinal = np.tile(np.arange(self.pps), self.B).astype(np.int32)
        self.first = np.zeros(G, np.int32)
        self.last = np.zeros(G, np.int32)
        self.valid = np.zeros(G, np.int32)
        self._n = np.zeros(self.B, np.int64)      # valid pages per slot
        self._tables = np.full((self.B, self.pps), trash_page, np.int32)

    def _npages(self, post_len):
        return max(1, -(-int(post_len) // self.page))

    def set_slot(self, b, table_row, post_len):
        """(Re)build slot b's segment: ``table_row`` is its block-table
        row (page ids, trash-padded), ``post_len`` the POST-write context
        length the next step attends."""
        n = self._npages(post_len)
        lo = b * self.pps
        self._tables[b, :] = table_row[:self.pps]
        seg = slice(lo, lo + self.pps)
        self.page_ids[seg] = self._tables[b, min(n, self.pps) - 1]
        self.page_ids[lo:lo + n] = self._tables[b, :n]
        self.first[seg] = 0
        self.last[seg] = 0
        self.valid[seg] = 0
        self.first[lo] = 1
        self.last[lo + n - 1] = 1
        self.valid[lo:lo + n] = 1
        self._n[b] = n

    def clear_slot(self, b):
        """Slot went inactive: one valid entry over the trash page (the
        step still writes the slot's dummy token somewhere)."""
        row = np.full(self.pps, self.trash, np.int32)
        self.set_slot(b, row, 1)

    def rollback_slot(self, b, post_len):
        """Speculative-verify rewind: shrink the segment back to cover
        exactly ``post_len`` written tokens, rebuilt from the stored
        table row (the same arrays a fresh ``set_slot`` gives)."""
        self.set_slot(b, self._tables[b], post_len)

    def advance_slot(self, b, post_len):
        """The context grew: extend the segment only when the new length
        crosses into a fresh page."""
        n = self._npages(post_len)
        cur = int(self._n[b])
        if n == cur:
            return
        lo = b * self.pps
        for j in range(cur, min(n, self.pps)):
            self.page_ids[lo + j] = self._tables[b, j]
            self.valid[lo + j] = 1
        self.last[lo + cur - 1] = 0
        self.last[lo + n - 1] = 1
        # re-point the segment's padding alias at the new last page
        self.page_ids[lo + n:lo + self.pps] = self._tables[b, n - 1]
        self._n[b] = n

    def meta(self):
        return {"seq": self.seq, "page": self.page_ids,
                "ordinal": self.ordinal, "first": self.first,
                "last": self.last, "valid": self.valid}

    def stacked(self):
        """A snapshot of the six arrays as one int32 [6, G] array."""
        return np.stack([self.meta()[k] for k in self.FIELDS])


def _check_meta(name, meta):
    """``meta`` if it is a [6, G] tensor (rows ``RaggedMetaBuilder.FIELDS``),
    else raise."""
    if not torch.is_tensor(meta) or meta.dim() != 2 or meta.shape[0] != 6 \
            or meta.shape[1] < 1:
        raise ValueError(f"{name}: meta must be an int32 [6, G] tensor; got "
                         f"{getattr(meta, 'shape', type(meta))}")
    return meta


# ----------------------------------------------------- plain versions --

def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens,
                          scale):
    """Reference math (``_paged_attention_xla``): q [B, H, D]; pages
    [P, page, Hkv, D]; tables [B, pps]; context_lens [B] -> [B, H, D].
    Rows with context_lens == 0 come out as zeros, as the kernel (and
    the Pallas kernel) writes them; the XLA reference instead averages
    V uniformly there, a row the serving path never produces."""
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    bt = block_tables.long().clamp(0, k_pages.shape[0] - 1)
    k = k_pages[bt].reshape(b, -1, hkv, d)           # [B, L, Hkv, D]
    v = v_pages[bt].reshape(b, -1, hkv, d)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    cl = context_lens.to(q.device).long()
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < cl[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p.to(v.dtype).float(), v.float())
    out = torch.where((cl > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention_ragged_plain(q, k_pages, v_pages, context_lens, meta,
                                 scale):
    """Reference math of ``_ragged_kernel``, all in f32: each valid entry
    g scores q[seq[g]] against page[g]'s keys, masking key ordinal *
    page + i >= context_lens[seq]; the entries of a sequence combine by
    softmax (the kernel's online softmax across entries, summed here in
    one pass) and divide by a safe sum (1 where it is 0). Padding entries
    (valid == 0) contribute nothing; rows with context_lens == 0 are
    zeros. q [B, H, D]; pages [P, page, Hkv, D] -> [B, H, D]."""
    b, h, d = q.shape
    num_pages, page, hkv, _ = k_pages.shape
    _check_meta("paged_attention_ragged", meta)
    m = meta.to(q.device).long()
    seq = m[0].clamp(0, b - 1)
    pid = m[1].clamp(0, num_pages - 1)
    valid = (m[5] > 0) & (m[0] >= 0) & (m[0] < b)
    k = k_pages[pid].float()                          # [G, page, Hkv, D]
    v = v_pages[pid].float()
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("ghd,gthd->ght", q.float()[seq], k) * scale
    ctx = context_lens.to(q.device).long()
    tok = m[2][:, None] * page + torch.arange(page, device=q.device)[None]
    s = torch.where((tok < ctx[seq][:, None])[:, None, :], s, NEG_INF)
    m_g = torch.where(valid[:, None], s.amax(dim=-1), NEG_INF)   # [G, H]
    big = torch.full((b, h), NEG_INF, device=q.device).scatter_reduce(
        0, seq[:, None].expand(-1, h), m_g, "amax")
    p = torch.where(valid[:, None, None],
                    torch.exp(s - big[seq][..., None]), 0.0)  # [G, H, page]
    l_sum = torch.zeros(b, h, device=q.device).index_add(0, seq, p.sum(-1))
    acc = torch.zeros(b, h, d, device=q.device).index_add(
        0, seq, torch.einsum("ght,gthd->ghd", p, v))
    out = acc / torch.where(l_sum == 0, 1.0, l_sum)[..., None]
    out = torch.where((ctx > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def _varq_plain(q, k_pages, v_pages, block_tables, kv_lens, q_lens, scale,
                key_lens=None):
    b, qb, h, d = q.shape
    hkv = k_pages.shape[2]
    bt = block_tables.long().clamp(0, k_pages.shape[0] - 1)
    k = k_pages[bt].reshape(b, -1, hkv, d)            # [B, L, Hkv, D]
    v = v_pages[bt].reshape(b, -1, hkv, d)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    dev = q.device
    kl = kv_lens.to(dev).long()
    ql = q_lens.to(dev).long()
    bound = kl if key_lens is None else torch.minimum(kl, key_lens.long())
    tok = torch.arange(k.shape[1], device=dev)
    qpos = (kl - ql)[:, None] + torch.arange(qb, device=dev)[None]
    ok = (tok[None, None, :] <= qpos[..., None]) \
        & (tok[None, None, :] < bound[:, None, None])     # [B, Qb, L]
    s = torch.where(ok[:, :, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    qvalid = (torch.arange(qb, device=dev)[None, :] < ql[:, None]) \
        & (kl > 0)[:, None]
    out = torch.where(qvalid[..., None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention_varq_plain(q, k_pages, v_pages, block_tables, kv_lens,
                               q_lens, scale):
    """Reference math (``_paged_attention_varq_xla``): q [B, Qb, H, D];
    pages [P, page, Hkv, D]; tables [B, pps]; kv_lens [B] keys per slot
    (span included); q_lens [B] span lengths. Query i of slot b sits at
    kv_lens - q_lens + i and attends to keys tok <= its position and
    tok < kv_lens. Scores f32; P is rounded to V's dtype before P.V,
    like the XLA reference. Padding rows (i >= q_lens) and slots with
    kv_lens == 0 are zeros."""
    return _varq_plain(q, k_pages, v_pages, block_tables, kv_lens, q_lens,
                       scale)


def _meta_pages(meta, b):
    """The block table [B, n] a ragged meta names (page of each valid
    entry at [seq, ordinal]) and the keys it covers per sequence."""
    m = meta.long()
    valid = (m[5] > 0) & (m[0] >= 0) & (m[0] < b)
    n = int(m[2][valid].max()) + 1 if bool(valid.any()) else 1
    tables = torch.zeros(b, n, dtype=torch.long, device=meta.device)
    tables[m[0][valid], m[2][valid]] = m[1][valid]
    covered = torch.zeros(b, dtype=torch.long, device=meta.device)
    covered.index_add_(0, m[0][valid], torch.ones_like(m[0][valid]))
    return tables, covered


def paged_attention_ragged_varq_plain(q, k_pages, v_pages, kv_lens, q_lens,
                                      meta, scale):
    """``paged_attention_varq_plain`` over the pages the ragged meta
    names: a sequence's keys stop where its valid entries stop, as in
    the kernel that walks them."""
    _check_meta("paged_attention_ragged_varq", meta)
    tables, covered = _meta_pages(meta.to(q.device), q.shape[0])
    return _varq_plain(q, k_pages, v_pages, tables, kv_lens, q_lens, scale,
                       key_lens=covered * k_pages.shape[1])


# ------------------------------------------------------ kernel wrappers --

def _check_paged(name, q, k_pages, v_pages, q_dims, ints):
    """Shared argument checks of the paged kernels: q has ``q_dims``
    dims ending in [H, D]; pages [P, page, Hkv, D], K and V of one dtype
    (q's or another of float32/bfloat16/float16); ``ints`` are int32
    tensors; everything contiguous on q's CUDA device."""
    if q.dim() != q_dims or k_pages.dim() != 4 \
            or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: want q of {q_dims} dims [..., H, D] and "
                         f"pages [P, page, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    h, d = q.shape[-2:]
    hkv, dk = k_pages.shape[2:]
    if dk != d or h % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}; the kernel takes q and pages "
                        "each of float32, bfloat16, float16, K and V pages "
                        "of one dtype")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got "
                            f"{t.dtype}")
    for t in (q, k_pages, v_pages, *ints):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: every input must be on q's CUDA "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: B = {q.shape[0]} exceeds the grid limit")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: pages must be 16-byte aligned (the "
                         "kernel reads them in 16-byte vectors)")


def paged_attention_kernel(q, k_pages, v_pages, block_tables, context_lens,
                           scale):
    """Launch ``csrc/paged_decode.cu`` on CUDA tensors: q [B, H, D],
    pages [P, page, Hkv, D] (each of float32/bfloat16/float16, D 64 or
    128, H % Hkv == 0), block_tables int32 [B, pps], context_lens int32
    [B]. Returns [B, H, D] in q's dtype."""
    _check_paged("paged_decode", q, k_pages, v_pages, 3,
                 (block_tables, context_lens))
    b, h, d = q.shape
    num_pages, page, hkv, _ = k_pages.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise TypeError("paged_decode: block_tables must be int32 [B, pps]")
    if context_lens.shape != (b,):
        raise TypeError("paged_decode: context_lens must be int32 [B]")
    out = torch.empty_like(q)
    lib = load("paged_decode", _SIGNATURES["paged_decode"])
    err = lib.paged_decode(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], d, q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(),
        out.data_ptr(), b, h, hkv, page, block_tables.shape[1], num_pages,
        float(scale), stream_ptr(q.device))
    check(err, "paged_decode")
    count_launch("paged_decode", q.dtype, k_pages.dtype)
    return out


def paged_attention_ragged_kernel(q, k_pages, v_pages, context_lens, meta,
                                  scale):
    """Launch ``csrc/ragged_decode.cu`` on CUDA tensors: q [B, H, D],
    pages [P, page, Hkv, D], context_lens int32 [B] (post-write lengths),
    meta int32 [6, G]. q and pages of one 16-bit dtype: one launch, each
    (sequence, KV head) walk split over a thread-block cluster. f32, or q
    and pages of different dtypes: two passes, a per-entry partial
    softmax into an f32 workspace [G, H, D + 2], then one combine per
    (sequence, head)."""
    _check_meta("ragged_decode", meta)
    _check_paged("ragged_decode", q, k_pages, v_pages, 3,
                 (context_lens, meta))
    b, h, d = q.shape
    num_pages, page, hkv, _ = k_pages.shape
    if context_lens.shape != (b,):
        raise TypeError("ragged_decode: context_lens must be int32 [B]")
    g = meta.shape[1]
    if g * page > 2**31 - 1 or hkv > 65535:
        raise ValueError("ragged_decode: grid too large")
    out = torch.empty_like(q)
    split = q.dtype == k_pages.dtype and q.dtype != torch.float32
    ws = None if split else torch.empty(
        g * h * (d + 2), dtype=torch.float32, device=q.device)
    lib = load("ragged_decode", _SIGNATURES["ragged_decode"])
    err = lib.ragged_decode(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], d, q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), meta.data_ptr(),
        context_lens.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), b, h, hkv,
        page, num_pages, g, float(scale), stream_ptr(q.device))
    check(err, "ragged_decode")
    count_launch("ragged_decode", q.dtype, k_pages.dtype)
    return out


def paged_attention_varq_kernel(q, k_pages, v_pages, kv_lens, q_lens, scale,
                                block_tables=None, meta=None):
    """Launch ``csrc/paged_varq.cu`` on CUDA tensors: q [B, Qb, H, D],
    pages [P, page, Hkv, D], kv_lens/q_lens int32 [B], and the slot's
    pages from exactly one of block_tables (int32 [B, pps]) or meta
    (int32 [6, G]). H / Hkv must be at most 64 (one tile's rows)."""
    if (block_tables is None) == (meta is None):
        raise ValueError("paged_varq: pass exactly one of block_tables, "
                         "meta")
    pages = block_tables if meta is None else _check_meta("paged_varq", meta)
    _check_paged("paged_varq", q, k_pages, v_pages, 4,
                 (kv_lens, q_lens, pages))
    b, qb, h, d = q.shape
    num_pages, page, hkv, _ = k_pages.shape
    if kv_lens.shape != (b,) or q_lens.shape != (b,):
        raise TypeError("paged_varq: kv_lens and q_lens must be int32 [B]")
    if h // hkv > _VARQ_MAX_GROUP:
        raise ValueError(f"paged_varq: query-head group {h // hkv} exceeds "
                         f"{_VARQ_MAX_GROUP}")
    if meta is None:
        if block_tables.dim() != 2 or block_tables.shape[0] != b:
            raise TypeError("paged_varq: block_tables must be int32 "
                            "[B, pps]")
        pps, g = block_tables.shape[1], 0
    else:
        pps, g = 0, meta.shape[1]
    rows = _VARQ_MAX_GROUP // (h // hkv)            # span rows per tile
    if -(-qb // rows) > 2**31 - 1 or hkv > 65535 \
            or max(pps, g) * page > 2**31 - 1:
        raise ValueError("paged_varq: grid too large")
    out = torch.empty_like(q)
    lib = load("paged_varq", _SIGNATURES["paged_varq"])
    err = lib.paged_varq(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype], d, q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        0 if meta is not None else block_tables.data_ptr(),
        0 if meta is None else meta.data_ptr(), kv_lens.data_ptr(),
        q_lens.data_ptr(), out.data_ptr(), b, qb, h, hkv, page, pps,
        num_pages, g, float(scale), stream_ptr(q.device))
    check(err, "paged_varq")
    count_launch("paged_varq", q.dtype, k_pages.dtype)
    return out


# ------------------------------------------------------------ entries --

def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _on_cuda(name, q):
    """True for a CUDA query, False for a CPU one (plain version)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def _i32(t):
    return t.to(torch.int32).contiguous()


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Single-step decode attention over a paged KV cache: q [B, H, D],
    k_pages/v_pages [num_pages, page_size, n_kv_heads, D], block_tables
    [B, pages_per_seq] page ids, context_lens [B] valid token counts ->
    [B, H, D]. A CPU query takes the plain version; a CUDA query
    launches the kernel or raises."""
    sc = _scale(q, scale)
    if not _on_cuda("paged_attention", q):
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     context_lens, sc)
    return paged_attention_kernel(q.contiguous(), k_pages, v_pages,
                                  _i32(block_tables), _i32(context_lens), sc)


def paged_attention_ragged(q, k_pages, v_pages, context_lens, meta,
                           scale=None):
    """Ragged-grid paged decode attention: q [B, H, D] attends over the
    (seq, page) work list in ``meta`` (built for the post-write lengths
    ``context_lens``). Sequences with context_lens == 0 give zeros. A
    CPU query takes the plain version; a CUDA query launches the kernel
    or raises."""
    sc = _scale(q, scale)
    if not _on_cuda("paged_attention_ragged", q):
        return paged_attention_ragged_plain(q, k_pages, v_pages,
                                            context_lens, meta, sc)
    return paged_attention_ragged_kernel(
        q.contiguous(), k_pages, v_pages, _i32(context_lens),
        _i32(_check_meta("paged_attention_ragged", meta)), sc)


def paged_attention_varq(q, k_pages, v_pages, block_tables, kv_lens,
                         q_lens, scale=None):
    """Mixed-step attention through block tables: q [B, Qb, H, D];
    kv_lens [B] total keys per slot (span included); q_lens [B] span
    lengths -> [B, Qb, H, D], padding query rows zero. A CPU query takes
    the plain version; a CUDA query launches ``paged_varq`` or raises."""
    sc = _scale(q, scale)
    if not _on_cuda("paged_attention_varq", q):
        return paged_attention_varq_plain(q, k_pages, v_pages, block_tables,
                                          kv_lens, q_lens, sc)
    return paged_attention_varq_kernel(
        q.contiguous(), k_pages, v_pages, _i32(kv_lens), _i32(q_lens), sc,
        block_tables=_i32(block_tables))


def paged_attention_ragged_varq(q, k_pages, v_pages, kv_lens, q_lens, meta,
                                scale=None):
    """Mixed-step attention over the ragged meta (built for the
    post-write kv_lens = span start + q_lens): q [B, Qb, H, D] ->
    [B, Qb, H, D]; padding query rows and kv_lens == 0 slots give zeros.
    A CPU query takes the plain version; a CUDA query launches
    ``paged_varq`` or raises."""
    sc = _scale(q, scale)
    if not _on_cuda("paged_attention_ragged_varq", q):
        return paged_attention_ragged_varq_plain(q, k_pages, v_pages,
                                                 kv_lens, q_lens, meta, sc)
    return paged_attention_varq_kernel(
        q.contiguous(), k_pages, v_pages, _i32(kv_lens), _i32(q_lens), sc,
        meta=_i32(_check_meta("paged_attention_ragged_varq", meta)))
