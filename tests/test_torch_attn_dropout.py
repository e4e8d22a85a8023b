"""The port's counter-hash attention dropout against the JAX reference.

``dropout_keep_mask`` is held bit for bit to the reference's (negative
and positive seeds, rows and positions above 2^16). The forward with
dropout and its three gradients are held, on the same seeded numpy
inputs and the same two seeds, to ``_gen_reference`` (and ``jax.vjp`` of
it) and to the reference's Pallas kernels in interpret mode
(``flash_attention_jax``, whose backward is ``_flash_bwd_pallas``), the
seeds handed to the reference by replacing its ``dropout_seeds`` inside
the test. head_dim is 64 or 128, so the reference's Pallas gate admits
every case. f32 tolerance: atol = rtol = 1e-5 (the same algorithm summed
in another order).

The ``cuda`` cases hold the three flash kernels with dropout against the
plain versions on the card and skip without one; run them with
``python -m pytest --noconftest -m cuda tests/test_torch_attn_dropout.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.attention import (additive_mask,
                                                dropout_keep_mask,
                                                dropout_threshold,
                                                flash_attention_bshd,
                                                flash_attention_bwd_kernel,
                                                flash_attention_bwd_plain,
                                                flash_attention_kernel,
                                                flash_attention_plain)

TOL = dict(atol=1e-5, rtol=1e-5)
NEG = -1e30
SEEDS = (-1234567891, 987654321)

# name: (B, Sq, Sk, H, Hkv, D, causal, mask kind, dropout p)
CASES = {
    "key_additive": (2, 16, 16, 4, 4, 64, False, "additive", 0.1),
    "key_bool": (2, 16, 16, 4, 4, 64, False, "bool", 0.1),
    "gqa_causal": (2, 24, 24, 4, 2, 64, True, None, 0.5),
    "sq_ne_sk_gqa_mask_d128": (1, 16, 40, 4, 2, 128, False, "additive", 0.1),
}


def _case(name, seed=0, cases=CASES):
    b, sq, sk, h, hkv, d, causal, mkind, p = cases[name]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, hkv, d).astype(np.float32)
    v = rng.randn(b, sk, hkv, d).astype(np.float32)
    g = rng.randn(b, sq, h, d).astype(np.float32)
    lens = rng.randint(sk // 2, sk + 1, (b,))
    keys = np.arange(sk)[None, :] < lens[:, None]            # [B, Sk]
    mask = None
    if mkind == "additive":          # BERT's (1 - m) * -1e4, [B, 1, 1, S]
        mask = ((1.0 - keys) * -1e4).astype(np.float32)[:, None, None, :]
    elif mkind == "bool":            # ERNIE's boolean key mask
        mask = keys[:, None, None, :]
    return q, k, v, g, causal, mask, p


def _ref_seeds(seeds):
    import jax.numpy as jnp
    return (jnp.zeros((1, 1, 128), jnp.int32)
            .at[0, 0, 0].set(seeds[0]).at[0, 0, 1].set(seeds[1]))


@pytest.fixture(params=["gen_reference", "pallas_interpret"])
def oracle(request):
    """The reference as ``_gen_reference`` (XLA), or as
    ``flash_attention_jax`` with its Pallas kernels in interpret mode
    (flags restored afterwards)."""
    if request.param == "gen_reference":
        yield request.param
        return
    from paddle_tpu.framework.flags import get_flags, set_flags
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        yield request.param
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})


def _ref_fn(q, k, v, causal, mask, p, seeds, oracle, monkeypatch):
    """f(q, k, v) of the reference with dropout p and the given seeds."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu.kernels.attention as RA
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if oracle == "gen_reference":
        mask3, bm, hm = None, 1, 1
        if mask is not None:
            m = np.where(mask, 0.0, NEG).astype(np.float32) \
                if mask.dtype == bool else mask
            m = np.broadcast_to(m, m.shape[:3] + (sk,))
            bm, hm = m.shape[:2]
            mask3 = jnp.asarray(m.reshape(bm * hm, m.shape[2], sk))
        arr = _ref_seeds(seeds)
        return lambda q_, k_, v_: RA._gen_reference(
            q_, k_, v_, mask3, None, arr, d ** -0.5, causal, p, bm, hm)
    monkeypatch.setattr(RA, "dropout_seeds", lambda key: _ref_seeds(seeds))
    jm = None if mask is None else jnp.asarray(mask)
    return lambda q_, k_, v_: RA.flash_attention_jax(
        q_, k_, v_, causal=causal, mask=jm, dropout_p=p,
        dropout_key=jax.random.key(0))


def _port_out_grads(q, k, v, g, causal, mask, p, seeds, monkeypatch,
                    dev="cpu", dtype=torch.float32):
    monkeypatch.setattr(prandom, "dropout_seeds", lambda: seeds)
    qt, kt, vt = (torch.from_numpy(a).to(dev, dtype).requires_grad_()
                  for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask).to(dev)
    out = flash_attention_bshd(qt, kt, vt, attn_mask=m, dropout_p=p,
                               is_causal=causal, training=True)
    grads = torch.autograd.grad(out, (qt, kt, vt),
                                torch.from_numpy(g).to(dev, dtype))
    return out.detach(), grads


# ------------------------------------------------------------- the hash --

@pytest.mark.parametrize("p", [1e-6, 0.1, 0.5, 0.9])
@pytest.mark.parametrize("seeds", [(-5, 7), (123456789, -2 ** 31),
                                   (2 ** 31 - 1, -1)])
def test_keep_mask_bit_for_bit(p, seeds):
    import jax.numpy as jnp
    from paddle_tpu.kernels.attention import dropout_keep_mask as ref
    rng = np.random.RandomState(3)
    # rows and positions past 2^16, and the corners of int32's range
    q = np.concatenate([rng.randint(0, 2 ** 20, 60), [0, 1, 2 ** 16,
                        2 ** 31 - 1]]).astype(np.int32)[:, None]
    k = np.concatenate([rng.randint(0, 2 ** 20, 60), [0, 3, 2 ** 17,
                        2 ** 31 - 2]]).astype(np.int32)[None, :]
    row = np.array([0, 7, 70000, 2 ** 30], np.int32)[:, None, None]
    want = np.asarray(ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(row),
                          seeds[0], seeds[1], 0, 0, p))
    got = dropout_keep_mask(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(row), seeds[0], seeds[1], p)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the keep rate is 1 - p within 6 binomial standard deviations
    n = want.size
    assert abs(got.float().mean().item() - (1 - p)) \
        <= 6 * (p * (1 - p) / n) ** 0.5 + 1e-6


@pytest.mark.parametrize("p", [0.0, 1e-10, 0.1, 0.5, 2 ** -33, 0.9999999999])
def test_threshold_matches_reference(p):
    """round(p * 2^32) on the host (ties to even), clamped to uint32."""
    thresh = np.uint32(min(0xFFFFFFFF, int(round(p * 4294967296.0))))
    assert dropout_threshold(p) == int(thresh)


# ---------------------------------------------------- forward, gradients --

@pytest.mark.parametrize("case", list(CASES))
def test_dropout_forward_matches_reference(case, oracle, monkeypatch):
    import jax.numpy as jnp
    q, k, v, g, causal, mask, p = _case(case)
    f = _ref_fn(q, k, v, causal, mask, p, SEEDS, oracle, monkeypatch)
    want = np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got, _ = _port_out_grads(q, k, v, g, causal, mask, p, SEEDS, monkeypatch)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # dropout really acted: the output differs from the p = 0 one
    m = None if mask is None else torch.from_numpy(mask)
    nodrop = flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  attn_mask=m, is_causal=causal)
    assert not torch.allclose(got, nodrop, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_dropout_grads_match_reference(case, oracle, monkeypatch):
    import jax
    import jax.numpy as jnp
    q, k, v, g, causal, mask, p = _case(case, seed=1)
    f = _ref_fn(q, k, v, causal, mask, p, SEEDS, oracle, monkeypatch)
    want = jax.jit(lambda *a: jax.vjp(f, *a[:3])[1](a[3]))(
        *(jnp.asarray(a) for a in (q, k, v, g)))
    _, got = _port_out_grads(q, k, v, g, causal, mask, p, SEEDS, monkeypatch)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_plain_versions_take_the_seeds():
    """The plain forward and backward with dropout at the seeds that the
    entry drew; other seeds give another output."""
    q, k, v, g, causal, mask, p = _case("key_additive", seed=2)
    qt, kt, vt, gt = (torch.from_numpy(a) for a in (q, k, v, g))
    m = additive_mask(torch.from_numpy(mask), *q.shape[:3], k.shape[1])
    sc = q.shape[-1] ** -0.5
    out, lse = flash_attention_plain(qt, kt, vt, sc, causal, m,
                                     return_lse=True, dropout_p=p,
                                     seeds=SEEDS)
    other = flash_attention_plain(qt, kt, vt, sc, causal, m, dropout_p=p,
                                  seeds=(SEEDS[0] + 1, SEEDS[1]))
    assert not torch.allclose(out, other, **TOL)
    # lse is the one without dropout
    _, lse0 = flash_attention_plain(qt, kt, vt, sc, causal, m,
                                    return_lse=True)
    torch.testing.assert_close(lse, lse0, atol=0, rtol=0)
    dq, dk, dv = flash_attention_bwd_plain(qt, kt, vt, out, lse, gt, sc,
                                           causal, m, dropout_p=p,
                                           seeds=SEEDS)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


def test_entry_draws_seeds_from_framework_random():
    """``flash_attention_bshd`` with dropout draws one seed pair per call
    from the host stream: one seed gives one sequence of patterns, the
    second call another pattern; ``training=False`` and ``dropout_p=0``
    give the output without dropout; p outside [0, 1) raises."""
    q, k, v, _, causal, mask, p = _case("gqa_causal", seed=4)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    prandom.seed(11)
    first = [flash_attention_bshd(qt, kt, vt, dropout_p=p, is_causal=causal)
             for _ in range(2)]
    prandom.seed(11)
    again = flash_attention_bshd(qt, kt, vt, dropout_p=p, is_causal=causal)
    torch.testing.assert_close(first[0], again, atol=0, rtol=0)
    assert not torch.allclose(first[0], first[1])
    plain = flash_attention_bshd(qt, kt, vt, is_causal=causal)
    evald = flash_attention_bshd(qt, kt, vt, dropout_p=p, is_causal=causal,
                                 training=False)
    torch.testing.assert_close(evald, plain, atol=0, rtol=0)
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            flash_attention_bshd(qt, kt, vt, dropout_p=bad)


def test_seed_stream_is_reproducible():
    prandom.seed(5)
    a = [prandom.dropout_seeds() for _ in range(3)]
    prandom.seed(5)
    assert [prandom.dropout_seeds() for _ in range(3)] == a
    assert len(set(a)) == 3
    assert all(-2 ** 31 <= s < 2 ** 31 - 1 for pair in a for s in pair)


# --------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# kernel vs plain version on the card: f32 sums in another order; bf16
# outputs at most one bf16 ulp apart (rtol), atol for small outputs
CARD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=5e-3, rtol=2e-2),
            torch.float16: dict(atol=1e-3, rtol=4e-3)}

CARD_CASES = dict(CASES, **{
    "bert_tail_100": (3, 100, 100, 4, 4, 64, False, "additive", 0.1),
    "causal_d128_tail": (1, 130, 130, 2, 1, 128, True, None, 0.3),
})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_dropout_kernels_match_plain(cuda, dtype, case):
    q, k, v, g, causal, mask, p = _case(case, seed=5, cases=CARD_CASES)
    q, k, v, g = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v, g))
    m = None if mask is None else additive_mask(
        torch.from_numpy(mask).to(cuda), *q.shape[:3], k.shape[1])
    sc = q.shape[-1] ** -0.5
    drop = dict(dropout_p=p, seeds=SEEDS)
    out, lse = flash_attention_kernel(q, k, v, sc, causal, m, **drop)
    want_out, want_lse = flash_attention_plain(q, k, v, sc, causal, m,
                                               return_lse=True, **drop)
    got = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal, m,
                                     **drop)
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, sc, causal, m,
                                     **drop)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want_out.float(), msg="out",
                               **CARD_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, msg="lse",
                               **CARD_TOL[torch.float32])
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all(), name
        torch.testing.assert_close(a.float(), w.float(), msg=name,
                                   **CARD_TOL[dtype])


@pytest.mark.cuda
def test_dropout_entry_trains_through_the_kernels(cuda, monkeypatch):
    """On CUDA tensors the entry with dropout launches the three kernels
    and gives the CPU plain path's output and gradients."""
    q, k, v, g, causal, mask, p = _case("key_bool", seed=6)
    reset_launch_counts()
    out, got = _port_out_grads(q, k, v, g, causal, mask, p, SEEDS,
                               monkeypatch, dev=cuda)
    torch.cuda.synchronize()
    assert (launch_counts["flash_fwd"], launch_counts["flash_bwd_dkdv"],
            launch_counts["flash_bwd_dq"]) == (1, 1, 1)
    want_out, want = _port_out_grads(q, k, v, g, causal, mask, p, SEEDS,
                                     monkeypatch)
    torch.testing.assert_close(out.cpu(), want_out, **CARD_TOL[torch.float32])
    for a, w in zip(got, want):
        torch.testing.assert_close(a.cpu(), w, **CARD_TOL[torch.float32])
