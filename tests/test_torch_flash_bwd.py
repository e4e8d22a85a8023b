"""The port's flash-attention and RMSNorm backward against the JAX
reference.

On the CPU, ``flash_attention_bshd`` differentiates through the plain
versions (forward with ``lse``, then ``flash_attention_bwd_plain``); its
gradients are held against ``jax.vjp`` of the reference's
``_gen_reference`` and against the reference's own backward through its
Pallas kernels in interpret mode (``_flash_bwd_pallas``), on the same
seeded numpy inputs. f32 tolerance: atol = rtol = 1e-5.

The ``cuda`` cases hold the two backward kernels of ``csrc/flash_bwd.cu``
against ``flash_attention_bwd_plain`` on the card (printing each bf16
case's largest error), check that two bf16 launches agree bit for bit,
and skip without a card; run them with ``python -m pytest --noconftest
-m cuda -s tests/test_torch_flash_bwd.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.attention import (flash_attention_bshd,
                                                flash_attention_bwd_kernel,
                                                flash_attention_bwd_plain,
                                                flash_attention_kernel,
                                                flash_bwd_dkdv_kernel)
from paddle_tpu_torch.kernels.norm import fused_rms_norm

TOL = dict(atol=1e-5, rtol=1e-5)
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
            torch.bfloat16: dict(atol=5e-3, rtol=2e-2)}

CARD_CASES = dict(CASES, **{
    "tail_100_d128": (2, 100, 100, 4, 1, 128, True, None, None),
    "sq_gt_sk_causal": (1, 130, 70, 2, 2, 64, True, None, None),
    "zero_kv_len": (2, 16, 16, 4, 4, 64, False, None, [16, 0]),
    # the training geometry (head_dim 128, causal) cut to 512 tokens
    "train_512": (1, 512, 512, 4, 4, 128, True, None, None),
})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
