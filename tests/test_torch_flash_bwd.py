"""The port's flash-attention and RMSNorm backward against the JAX
reference.

On the CPU, ``flash_attention_bshd`` differentiates through the plain
versions (forward with ``lse``, then ``flash_attention_bwd_plain``); its
gradients are held against ``jax.vjp`` of the reference's
``_gen_reference`` and against the reference's own backward through its
Pallas kernels in interpret mode (``_flash_bwd_pallas``), on the same
seeded numpy inputs. f32 tolerance: atol = rtol = 1e-5. In f16 the
plain versions are held to the Pallas backward on the same f16 inputs
(``TOL16``).

The ``cuda`` cases hold the two backward kernels of ``csrc/flash_bwd.cu``
against ``flash_attention_bwd_plain`` on the card in f32, bf16 and f16
(printing each case's largest error), the f32 instances also at the
BERT-base fine-tune's shape, check that two launches agree bit for bit
and that f32 launches take the route ``bwd_route`` names, hold the f16
kernels to the plain version
with dO multiplied by a loss scale, and skip without a card; run them with ``python -m pytest --noconftest
-m cuda -s tests/test_torch_flash_bwd.py``.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import (launch_counts, reset_launch_counts,
                                      route_counts)
from paddle_tpu_torch.kernels.attention import (bwd_route,
                                                flash_attention_bshd,
                                                flash_attention_bwd_kernel,
                                                flash_attention_bwd_plain,
                                                flash_attention_kernel,
                                                flash_bwd_dkdv_kernel)
from paddle_tpu_torch.kernels.norm import fused_rms_norm

TOL = dict(atol=1e-5, rtol=1e-5)
# kernel vs plain version on the card in f16: the sums of one f32
# arithmetic taken in another order, rounded to f16 (an ulp is 2^-10
# relative); atol for outputs near 0 (chip_smoke.py's TOL["float16"])
TOL16 = dict(atol=1e-3, rtol=4e-3)
# port vs reference in f16 on the CPU: each side also rounds its forward's
# O to f16 (delta = rowsum(dO * O) follows it) and its f16 outputs, so an
# output near 0 whose terms reach the tensor's largest |value| can differ
# by an f16 ulp of that value or two: atol is 2^-9 of the largest |value|
REF16_RTOL, REF16_ATOL_OF_MAX = 4e-3, 2.0 ** -9
NEG = -1e30

# name: (B, Sq, Sk, H, Hkv, D, causal, mask kind, kv_lens)
CASES = {
    "causal": (2, 16, 16, 4, 4, 64, True, None, None),
    "noncausal_gqa_d128": (2, 16, 16, 4, 2, 128, False, None, None),
    "sq_ne_sk_mask": (2, 16, 40, 4, 2, 64, False, "keys", None),
    "tail_causal_gqa": (1, 136, 136, 4, 2, 64, True, None, None),
    "kv_lens": (2, 16, 16, 4, 4, 64, True, None, [16, 9]),
    "mask_kv_lens_sq_ne_sk": (2, 24, 40, 4, 2, 64, False, "full", [40, 23]),
    "no_valid_key": (2, 16, 16, 4, 2, 64, False, "dead_batch", None),
    # the edges of the bf16 kernels' tiles: 64 query rows, 64 keys
    "tail_200_129": (1, 200, 129, 4, 1, 128, True, None, None),
    "gqa4_d128_kvlens": (2, 72, 136, 8, 2, 128, False, None, [136, 65]),
}


def _case(name, seed=0, cases=CASES):
    b, sq, sk, h, hkv, d, causal, mkind, lens = cases[name]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, hkv, d).astype(np.float32)
    v = rng.randn(b, sk, hkv, d).astype(np.float32)
    g = rng.randn(b, sq, h, d).astype(np.float32)
    mask = None
    if mkind == "keys":                   # key padding, broadcast over q
        mask = np.where(rng.rand(b, 1, 1, sk) < 0.3, NEG, 0.0)
        mask[..., 0] = 0.0
    elif mkind == "full":                 # per-head, per-query entries
        mask = np.where(rng.rand(b, h, sq, sk) < 0.3, NEG, 0.0)
        mask[..., 0] = 0.0
    elif mkind == "dead_batch":           # batch 1 has no valid key
        mask = np.zeros((b, 1, 1, sk))
        mask[1] = NEG
    if mask is not None:
        mask = mask.astype(np.float32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    return q, k, v, g, causal, mask, lens


def _port_grads(q, k, v, g, causal, mask, lens, dtype=torch.float32,
                dev="cpu"):
    qt, kt, vt = (torch.from_numpy(a).to(dev, dtype).requires_grad_()
                  for a in (q, k, v))
    out = flash_attention_bshd(
        qt, kt, vt, attn_mask=None if mask is None
        else torch.from_numpy(mask).to(dev),
        is_causal=causal, kv_lens=lens)
    return torch.autograd.grad(out, (qt, kt, vt),
                               torch.from_numpy(g).to(dev, dtype))


def _vjp(f, q, k, v, g):
    """Gradients of f at (q, k, v) along g, traced and compiled as one
    program."""
    import jax
    grads = jax.jit(lambda *a: jax.vjp(f, *a[:3])[1](a[3]))(q, k, v, g)
    return [np.asarray(x) for x in grads]


def _ref_grads(q, k, v, g, causal, mask, lens, oracle):
    """Reference gradients: jax.vjp of ``_gen_reference`` (its exact
    semantics, XLA), or of ``flash_attention_jax`` with the Pallas
    kernels in interpret mode, whose custom_vjp backward runs
    ``_bwd_pallas_bshd`` -> ``_flash_bwd_pallas``."""
    import jax.numpy as jnp
    from paddle_tpu.framework.flags import get_flags, set_flags
    from paddle_tpu.kernels.attention import (_gen_reference,
                                              flash_attention_jax)
    d = q.shape[-1]
    jl = None if lens is None else jnp.asarray(lens)
    if oracle == "gen_reference":
        mask3, bm, hm = None, 1, 1
        if mask is not None:
            bm, hm = mask.shape[:2]
            mask3 = jnp.asarray(mask.reshape(bm * hm, *mask.shape[2:]))

        def f(q_, k_, v_):
            return _gen_reference(q_, k_, v_, mask3, jl, None, d ** -0.5,
                                  causal, 0.0, bm, hm)
        return _vjp(f, q, k, v, g)
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        def f(q_, k_, v_):
            return flash_attention_jax(
                q_, k_, v_, causal=causal, kv_lens=jl,
                mask=None if mask is None else jnp.asarray(mask))
        return _vjp(f, q, k, v, g)
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})


@pytest.mark.parametrize("oracle", ["gen_reference", "pallas_interpret"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_grads_match_reference(case, oracle):
    q, k, v, g, causal, mask, lens = _case(case)
    got = [t.numpy() for t in _port_grads(q, k, v, g, causal, mask, lens)]
    want = _ref_grads(q, k, v, g, causal, mask, lens, oracle)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), f"{name} not finite"
        if case == "no_valid_key":
            # a row with no valid key: the reference's softmax spreads it
            # uniformly, its Pallas path and the port give P = exp(s - lse)
            # = 1 at s = lse = -1e30; only finiteness is shared, so batch 1
            # is held to that and batch 0 to the reference
            a, w = a[:1], w[:1]
        np.testing.assert_allclose(a, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_grads_f16_match_pallas_interpret(case):
    """f16 q, k, v and dO: the plain forward and backward (what a CPU
    tensor takes) against the reference's Pallas backward in interpret
    mode on the same f16 inputs; both compute in f32 and round their
    outputs to f16."""
    q, k, v, g, causal, mask, lens = (
        a.astype(np.float16) if isinstance(a, np.ndarray)
        and a.dtype == np.float32 and a.ndim == 4 and i != 5 else a
        for i, a in enumerate(_case(case)))
    got = [t for t in _port_grads(q.astype(np.float32),
                                  k.astype(np.float32), v.astype(np.float32),
                                  g.astype(np.float32), causal, mask, lens,
                                  dtype=torch.float16)]
    want = _ref_grads(q, k, v, g, causal, mask, lens, "pallas_interpret")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float16 and w.dtype == np.float16, name
        a = a.float().numpy()
        assert np.isfinite(a).all(), f"{name} not finite"
        if case == "no_valid_key":
            a, w = a[:1], w[:1]           # as in the f32 test above
        w = w.astype(np.float32)
        np.testing.assert_allclose(
            a, w, err_msg=name, rtol=REF16_RTOL,
            atol=REF16_ATOL_OF_MAX * float(np.abs(w).max()))


def test_flash_grads_without_grad_stay_forward_only():
    """No input requiring grad (or no_grad): the forward-only path, with
    the same output as the differentiable one."""
    q, k, v, g, causal, mask, lens = _case("kv_lens")
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    plain = flash_attention_bshd(qt, kt, vt, is_causal=True, kv_lens=lens)
    assert plain.grad_fn is None
    qg = qt.clone().requires_grad_()
    out = flash_attention_bshd(qg, kt, vt, is_causal=True, kv_lens=lens)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), plain, atol=0, rtol=0)
    with torch.no_grad():
        assert flash_attention_bshd(qg, kt, vt, is_causal=True).grad_fn \
            is None


def test_flash_mask_requiring_grad_raises():
    q = torch.zeros(1, 8, 2, 64, requires_grad=True)
    mask = torch.zeros(1, 1, 8, 8, requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attention_bshd(q, q, q, attn_mask=mask)
    with pytest.raises(NotImplementedError):
        flash_attention_bshd(q, q, q, attn_mask=mask, dropout_p=0.1,
                             training=True)


def test_flash_bwd_kernel_refuses_cpu_tensors():
    q = torch.randn(1, 8, 2, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        flash_bwd_dkdv_kernel(q, q, q, q, lse, lse, 0.125)


# (q dtype, head_dim, dropout_p) -> the backward's device kernel
BWD_ROUTES = [((dt, d, p), "wgmma_f32" if dt == torch.float32 else "wgmma")
              for dt in (torch.float32, torch.bfloat16, torch.float16)
              for d in (64, 128) for p in (0.0, 0.1)]


@pytest.mark.parametrize("args,route", BWD_ROUTES,
                         ids=[f"{str(dt)[6:]}-d{d}-p{p}"
                              for (dt, d, p), _ in BWD_ROUTES])
def test_bwd_route_rule(args, route):
    """Both backward kernels run on the tensor cores in every dtype and
    head_dim they take, with or without dropout: bf16 and f16 on their own
    operands, f32 on bf16 parts of its operands."""
    assert bwd_route(*args) == route


# -------------------------------------------------------------- RMSNorm --

@pytest.mark.parametrize("shape", [(6, 128), (2, 3, 256)])
def test_rms_norm_grads_match_reference(shape):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.kernels.norm import fused_rms_norm as ref_rms
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, pull = jax.vjp(lambda a, b: ref_rms(a, b, 1e-6), jnp.asarray(x),
                      jnp.asarray(w))
    want = [np.asarray(t) for t in pull(jnp.asarray(g))]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(fused_rms_norm(xt, wt, 1e-6), (xt, wt),
                              torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


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
            torch.float16: TOL16}

CARD_CASES = dict(CASES, **{
    "tail_100_d128": (2, 100, 100, 4, 1, 128, True, None, None),
    "sq_gt_sk_causal": (1, 130, 70, 2, 2, 64, True, None, None),
    "zero_kv_len": (2, 16, 16, 4, 4, 64, False, None, [16, 0]),
    # the training geometry (head_dim 128, causal) cut to 512 tokens
    "train_512": (1, 512, 512, 4, 4, 128, True, None, None),
})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_flash_bwd_kernels_match_plain(cuda, dtype, case):
    q, k, v, g, causal, mask, lens = _case(case, seed=5, cases=CARD_CASES)
    q, k, v, g = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v, g))
    m = None if mask is None else torch.from_numpy(mask).to(cuda)
    kl = None if lens is None else torch.from_numpy(lens).to(cuda)
    sc = q.shape[-1] ** -0.5
    out, lse = flash_attention_kernel(q, k, v, sc, causal, m, kl)
    got = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal, m, kl)
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, sc, causal, m, kl)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.isfinite(a.float()).all(), name
        err = float((a.float() - w.float()).abs().max())
        top = float(w.float().abs().max())
        # the bf16 kernels' products take P and dS as bf16 hi + lo parts;
        # `pytest -s` shows how far that lands from the f32 plain version
        print(f"{case} {dtype} {name}: max abs err {err:.3e}, largest "
              f"|value| {top:.3e}, ratio {err / max(top, 1e-30):.3e}")
        torch.testing.assert_close(a.float(), w.float(), msg=name,
                                   **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["train_512", "gqa4_d128_kvlens"])
def test_flash_bwd_bf16_launches_are_bitwise_repeatable(cuda, case):
    """Two launches of the bf16 backward on the same inputs give bitwise
    equal dQ, dK and dV: each output tile has one owner block and no
    atomics (the resume check of chip_smoke.py relies on it)."""
    q, k, v, g, causal, mask, lens = _case(case, seed=7, cases=CARD_CASES)
    q, k, v, g = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (q, k, v, g))
    kl = None if lens is None else torch.from_numpy(lens).to(cuda)
    sc = q.shape[-1] ** -0.5
    out, lse = flash_attention_kernel(q, k, v, sc, causal, None, kl)
    first = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal,
                                       None, kl)
    again = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal,
                                       None, kl)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["train_512", "gqa4_d128_kvlens"])
def test_flash_bwd_f16_launches_are_bitwise_repeatable(cuda, case):
    """As the bf16 test above, for the f16 instances (their per-row
    rescale of dS changes nothing in the owner-per-tile argument)."""
    q, k, v, g, causal, mask, lens = _case(case, seed=7, cases=CARD_CASES)
    q, k, v, g = (torch.from_numpy(a).to(cuda, torch.float16)
                  for a in (q, k, v, g))
    kl = None if lens is None else torch.from_numpy(lens).to(cuda)
    sc = q.shape[-1] ** -0.5
    out, lse = flash_attention_kernel(q, k, v, sc, causal, None, kl)
    first = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal,
                                       None, kl)
    again = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal,
                                       None, kl)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["train_512", "gqa4_d128_kvlens",
                                  "tail_causal_gqa"])
def test_flash_bwd_f32_launches_are_bitwise_repeatable(cuda, case):
    """As the bf16 test above, for the f32 instances (f32 operands as
    bf16 parts, products in a fixed order), each launch counted on
    the route ``bwd_route`` names."""
    q, k, v, g, causal, mask, lens = _case(case, seed=7, cases=CARD_CASES)
    q, k, v, g = (torch.from_numpy(a).to(cuda) for a in (q, k, v, g))
    kl = None if lens is None else torch.from_numpy(lens).to(cuda)
    sc = q.shape[-1] ** -0.5
    out, lse = flash_attention_kernel(q, k, v, sc, causal, None, kl)
    reset_launch_counts()
    first = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal,
                                       None, kl)
    again = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, causal,
                                       None, kl)
    torch.cuda.synchronize()
    route = bwd_route(torch.float32, q.shape[-1])
    assert dict(route_counts) == {("flash_bwd_dkdv", route): 2,
                                  ("flash_bwd_dq", route): 2}
    for name, a, b in zip(("dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


# BERT-base's attention, q[16, 128, 12, 64], each row's keys padded past a
# length in [32, 128] by an additive key mask (the fine-tune's batches)
BERT_BWD = {"key_mask": (12, None, 0.0), "key_mask_dropout": (12, None, 0.1),
            "gqa_kv_lens": (4, "lens", 0.0),
            "gqa_kv_lens_dropout": (3, "lens", 0.1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BERT_BWD))
def test_flash_bwd_f32_bert_shape(cuda, case):
    """The f32 instances at the BERT-base fine-tune's shape with its key
    mask (and GQA with kv_lens, and dropout 0.1) against the plain
    backward at the f32 card tolerance; a second launch bitwise equal;
    every launch on the ``wgmma_f32`` route."""
    hkv, lens_kind, p = BERT_BWD[case]
    b, s, h, d = 16, 128, 12, 64
    rng = np.random.RandomState(9)
    q, g = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
            .to(cuda) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, s, hkv, d).astype(np.float32))
            .to(cuda) for _ in range(2))
    n = rng.randint(32, s + 1, size=b)
    mask = torch.from_numpy(np.where(np.arange(s)[None, :] < n[:, None],
                                     0.0, -1e4).astype(np.float32))
    mask = mask[:, None, None, :].to(cuda)
    kl = torch.from_numpy(np.maximum(n - 7, 1).astype(np.int32)).to(cuda) \
        if lens_kind else None
    drop = dict(dropout_p=p, seeds=(-1234567891, 987654321) if p else None)
    sc = d ** -0.5
    out, lse = flash_attention_kernel(q, k, v, sc, False, mask, kl, **drop)
    reset_launch_counts()
    got = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, False, mask,
                                     kl, **drop)
    again = flash_attention_bwd_kernel(q, k, v, out, lse, g, sc, False, mask,
                                       kl, **drop)
    want = flash_attention_bwd_plain(q, k, v, out, lse, g, sc, False, mask,
                                     kl, **drop)
    torch.cuda.synchronize()
    assert dict(route_counts) == {("flash_bwd_dkdv", "wgmma_f32"): 2,
                                  ("flash_bwd_dq", "wgmma_f32"): 2}
    for name, a, r, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, r), name
        print(f"{case} {name}: max abs err "
              f"{float((a - w).abs().max()):.3e}, largest |value| "
              f"{float(w.abs().max()):.3e}")
        torch.testing.assert_close(a, w, msg=name,
                                   **CARD_TOL[torch.float32])


def loss_scale_for(q, k, v, out, lse, g, sc, causal, kl, target=2.0 ** 14):
    """The power of two s that puts the plain backward's largest |dK|
    for ``s * g`` in (target / 2, target]: the backward is linear in dO."""
    dk = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                   out.float(), lse, g.float(), sc, causal,
                                   None, kl)[1]
    return 2.0 ** math.floor(math.log2(target / float(dk.abs().max())))


def max_ds(q, k, v, out, lse, g, sc, causal, kl):
    """The plain backward's largest |dS| = |P * (dP - delta)| over the
    kept entries."""
    from paddle_tpu_torch.kernels.attention import _keep, _repeat_kv, bwd_delta
    h = q.shape[2]
    kf, vf = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sc
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), vf)
    ds = p * (dp - bwd_delta(out, g)[..., None])
    keep = _keep(q.shape[1], k.shape[1], causal, kl, q.device)
    if keep is not None:
        ds = torch.where(keep, ds, 0.0)
    return float(ds.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["2^15", "dk_near_2^14", "ds_past_f16"])
@pytest.mark.parametrize("case", ["train_512", "gqa4_d128_kvlens",
                                  "tail_causal_gqa"])
def test_flash_bwd_f16_loss_scaled(cuda, case, scale):
    """dO of a loss gradient's size (N(0, 2^-8)) multiplied by a loss
    scale: GradScaler's default 2^15, the power of two that brings the
    largest |dK| near 2^14, or the largest that keeps dO finite in f16,
    where the largest |dS| passes f16's 65504 (dK and dQ may overflow
    there too: only the plain version's finite values are compared). The kernels' outputs are finite wherever the plain
    version's are, and within the f16 tolerance of it once both are
    divided by the scale (the gradient the scaler hands the optimizer)."""
    q, k, v, g, causal, mask, lens = _case(case, seed=8, cases=CARD_CASES)
    if scale == "ds_past_f16":
        v = v * 8.0       # dP = dO . V eight times larger: dS passes 65504
    q, k, v = (torch.from_numpy(a).to(cuda, torch.float16) for a in (q, k, v))
    g = torch.from_numpy(g).to(cuda) * 2.0 ** -8
    kl = None if lens is None else torch.from_numpy(lens).to(cuda)
    sc = q.shape[-1] ** -0.5
    out, lse = flash_attention_kernel(q, k, v, sc, causal, None, kl)
    if scale == "2^15":
        s = 2.0 ** 15
    elif scale == "dk_near_2^14":
        s = loss_scale_for(q, k, v, out, lse, g, sc, causal, kl)
    else:        # the largest scale that keeps dO finite in f16
        s = 2.0 ** math.floor(math.log2(65504 / float(g.abs().max())))
    gs = (g * s).half()
    if scale == "ds_past_f16":
        assert max_ds(q, k, v, out, lse, gs, sc, causal, kl) > 65504
    got = flash_attention_bwd_kernel(q, k, v, out, lse, gs, sc, causal,
                                     None, kl)
    want = flash_attention_bwd_plain(q, k, v, out, lse, gs, sc, causal,
                                     None, kl)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        fin = torch.isfinite(w)
        assert torch.isfinite(a[fin]).all(), name
        print(f"{case} x{s:g} {name}: largest |value| "
              f"{float(w[fin].float().abs().max()):.3e}")
        torch.testing.assert_close(a[fin].float() / s, w[fin].float() / s,
                                   msg=name, **TOL16)


@pytest.mark.cuda
def test_flash_bshd_trains_through_the_kernels(cuda):
    """On CUDA tensors that require grad, the entry launches the forward
    kernel and both backward kernels, and its gradients are the plain
    autograd path's."""
    q, k, v, g, causal, mask, lens = _case("tail_causal_gqa", seed=6)
    reset_launch_counts()
    got = _port_grads(q, k, v, g, causal, mask, lens, dev=cuda)
    torch.cuda.synchronize()
    assert (launch_counts["flash_fwd"], launch_counts["flash_bwd_dkdv"],
            launch_counts["flash_bwd_dq"]) == (1, 1, 1)
    want = _port_grads(q, k, v, g, causal, mask, lens)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.cpu(), w, **CARD_TOL[torch.float32])
