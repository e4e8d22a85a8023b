"""The port's LayerNorm (``kernels/norm.py``: plain version, analytic
backward, ``fused_layer_norm``; ``nn.functional.layer_norm``; the
``incubate`` entry) against the JAX reference.

On the CPU ``fused_layer_norm`` takes ``layer_norm_plain``; it is held
against the reference's ``_ln_core`` through its XLA path and through
its Pallas kernel (``_ln_kernel``) in interpret mode, and its gradients
against ``jax.vjp`` of ``_ln_core``. f32 tolerance: atol = rtol = 1e-5
(the same algorithm summed in another order); bf16 within one bf16 ulp
(the port keeps f32 statistics, as ``_ln_core`` does). The port's
``F.layer_norm`` is held to the reference's ``F.layer_norm`` at f32 only:
the reference computes that one in the input's dtype (ROADMAP Queue 3).

The ``cuda`` cases hold the Triton kernel against the plain version on
the card and skip without one; run them with ``python -m pytest
--noconftest -m cuda tests/test_torch_layer_norm.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn.functional import \
    fused_layer_norm as incubate_fused_layer_norm
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.norm import (fused_layer_norm,
                                           layer_norm_kernel,
                                           layer_norm_plain)
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as PF

TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: outputs rounded once from f32 statistics on both sides, so they
# differ by at most one bf16 ulp (2^-7 relative) where the f32 values
# straddle a rounding boundary
BF16_TOL = dict(atol=1e-2, rtol=2 ** -7)
SHAPES = [(6, 128), (2, 5, 768), (3, 4, 128)]


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


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3 + 1.5).astype(np.float32)
    w = (1 + 0.3 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.5 * rng.randn(shape[-1])).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_matches_ln_core(ref_mode, shape):
    import jax.numpy as jnp
    from paddle_tpu.kernels.norm import _ln_core
    x, w, b, _ = _inputs(shape)
    want = np.asarray(_ln_core(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), 1e-12))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got = fused_layer_norm(xt, wt, bt, 1e-12)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = layer_norm_plain(xt.reshape(-1, shape[-1]), wt, bt, 1e-12)
    np.testing.assert_allclose(plain.reshape(shape).numpy(), want, **TOL)
    inc = incubate_fused_layer_norm(xt, wt, bt, epsilon=1e-12)
    torch.testing.assert_close(inc, got, atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(6, 128), (2, 5, 768)])
def test_layer_norm_bf16_matches_ln_core(ref_mode, shape):
    import jax.numpy as jnp
    from paddle_tpu.kernels.norm import _ln_core
    x, w, b, _ = _inputs(shape, seed=1)
    want = np.asarray(_ln_core(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), 1e-5)
                      .astype(jnp.float32))
    got = fused_layer_norm(*(torch.from_numpy(a).bfloat16()
                             for a in (x, w, b)), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_grads_match_reference(shape):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.kernels.norm import _ln_core
    x, w, b, g = _inputs(shape, seed=2)
    _, pull = jax.vjp(lambda a, c, d: _ln_core(a, c, d, 1e-5),
                      *(jnp.asarray(a) for a in (x, w, b)))
    want = [np.asarray(t) for t in pull(jnp.asarray(g))]
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = torch.autograd.grad(fused_layer_norm(xt, wt, bt, 1e-5),
                              (xt, wt, bt), torch.from_numpy(g))
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a.numpy(), r, err_msg=name, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_functional_layer_norm_matches_reference(shape):
    """``F.layer_norm`` over the last axis with weight and bias and
    without them (ones and zeros into the fused entry), values and
    gradients, at f32."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF
    x, w, b, g = _inputs(shape, seed=3)
    d = shape[-1]
    for with_wb in (True, False):
        rx = paddle.to_tensor(x)
        rx.stop_gradient = False
        args = []
        if with_wb:
            rw, rb = paddle.to_tensor(w), paddle.to_tensor(b)
            rw.stop_gradient = rb.stop_gradient = False
            args = [rw, rb]
        rout = RF.layer_norm(rx, [d], *args, epsilon=1e-12)
        (rout * paddle.to_tensor(g)).sum().backward()
        xt = torch.from_numpy(x).requires_grad_()
        wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
        out = PF.layer_norm(xt, [d], *([wt, bt] if with_wb else []),
                            epsilon=1e-12)
        np.testing.assert_allclose(out.detach().numpy(), rout.numpy(),
                                   **TOL)
        out.backward(torch.from_numpy(g))
        np.testing.assert_allclose(xt.grad.numpy(), rx.grad.numpy(), **TOL)
        if with_wb:
            np.testing.assert_allclose(wt.grad.numpy(), rw.grad.numpy(),
                                       **TOL)
            np.testing.assert_allclose(bt.grad.numpy(), rb.grad.numpy(),
                                       **TOL)


def test_layer_norm_layer_and_plain_forms():
    """The ``LayerNorm`` layer goes through the fused entry; a
    two-axis normalized shape without weight or bias normalizes over
    both axes."""
    x, w, b, _ = _inputs((2, 3, 128), seed=4)
    ln = LayerNorm(128, epsilon=1e-12)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x)
    torch.testing.assert_close(ln(xt), fused_layer_norm(
        xt, ln.weight, ln.bias, 1e-12), atol=0, rtol=0)
    two = PF.layer_norm(xt, [3, 128], epsilon=1e-5)
    flat = xt.reshape(2, -1)
    want = (flat - flat.mean(-1, keepdim=True)) / torch.sqrt(
        flat.var(-1, unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(two, want.reshape(xt.shape), **TOL)


FORMS = {"no_weight_no_bias": (False, False, 1),
         "weight_only": (True, False, 1),
         "bias_only": (False, True, 1),
         "two_axes": (True, True, 2)}


@pytest.mark.parametrize("form", list(FORMS))
def test_functional_layer_norm_takes_the_fused_entry_in_every_form(
        form, monkeypatch):
    """Every form of ``F.layer_norm`` reaches ``_LayerNorm`` (on the CPU
    its plain version; on CUDA the kernel, so no form stays off it), the
    trailing axes flattened into one row, and matches the reference's
    ``F.layer_norm`` at f32, gradients included."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF
    from paddle_tpu_torch.kernels import norm
    with_w, with_b, n_axes = FORMS[form]
    x, _, _, g = _inputs((2, 3, 128), seed=6)
    rng = np.random.RandomState(7)
    ns = list(x.shape[-n_axes:])
    w = (1 + 0.3 * rng.randn(*ns)).astype(np.float32)
    b = (0.5 * rng.randn(*ns)).astype(np.float32)
    rows = []
    plain = norm.layer_norm_plain

    def spy(x2d, *a):
        rows.append(tuple(x2d.shape))
        return plain(x2d, *a)
    monkeypatch.setattr(norm, "layer_norm_plain", spy)
    rx = paddle.to_tensor(x)
    rx.stop_gradient = False
    rargs = {}
    xt = torch.from_numpy(x).requires_grad_()
    targs = {}
    for key, on, a in (("weight", with_w, w), ("bias", with_b, b)):
        if on:
            rargs[key] = paddle.to_tensor(a)
            rargs[key].stop_gradient = False
            targs[key] = torch.from_numpy(a).requires_grad_()
    rout = RF.layer_norm(rx, ns, epsilon=1e-5, **rargs)
    (rout * paddle.to_tensor(g)).sum().backward()
    out = PF.layer_norm(xt, ns, epsilon=1e-5, **targs)
    assert rows == [(int(np.prod(x.shape[:-n_axes])), int(np.prod(ns)))]
    np.testing.assert_allclose(out.detach().numpy(), rout.numpy(), **TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), rx.grad.numpy(), **TOL)
    for key, t in targs.items():
        np.testing.assert_allclose(t.grad.numpy(), rargs[key].grad.numpy(),
                                   err_msg=key, **TOL)


def test_functional_layer_norm_refuses_a_shape_that_is_not_trailing():
    with pytest.raises(ValueError):
        PF.layer_norm(torch.randn(2, 3, 128), [3], epsilon=1e-5)


def test_layer_norm_kernel_refuses_cpu_tensors():
    x = torch.randn(4, 128)
    with pytest.raises(ValueError):
        layer_norm_kernel(x, torch.ones(128), torch.zeros(128), 1e-5)
    with pytest.raises(TypeError):
        layer_norm_kernel(x.double(), torch.ones(128, dtype=torch.float64),
                          torch.zeros(128, dtype=torch.float64), 1e-5)
    with pytest.raises(ValueError):
        layer_norm_kernel(x, torch.ones(64), torch.zeros(128), 1e-5)


# --------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# f16 keeps 3 more bits than bf16 (2^-10 relative): its tolerance is the
# bf16 one over 5
CARD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=5e-3, rtol=2e-2),
            torch.float16: dict(atol=1e-3, rtol=4e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [768, 128, 1000])
def test_layer_norm_kernel_matches_plain(cuda, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (3 * torch.randn(37, d, device=cuda, generator=g) + 1).to(dtype)
    w = torch.randn(d, device=cuda, generator=g).to(dtype)
    b = torch.randn(d, device=cuda, generator=g).to(dtype)
    reset_launch_counts()
    got = layer_norm_kernel(x, w, b, 1e-12)
    torch.cuda.synchronize()
    assert launch_counts["layer_norm"] == 1
    torch.testing.assert_close(got.float(),
                               layer_norm_plain(x, w, b, 1e-12).float(),
                               **CARD_TOL[dtype])


@pytest.mark.cuda
def test_functional_layer_norm_trains_through_the_kernel(cuda):
    x, w, b, gr = _inputs((2, 5, 768), seed=5)
    reset_launch_counts()
    xt, wt, bt = (torch.from_numpy(a).to(cuda).requires_grad_()
                  for a in (x, w, b))
    got = torch.autograd.grad(PF.layer_norm(xt, [768], wt, bt, 1e-12),
                              (xt, wt, bt), torch.from_numpy(gr).to(cuda))
    torch.cuda.synchronize()
    assert launch_counts["layer_norm"] == 1
    xc, wc, bc = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    want = torch.autograd.grad(PF.layer_norm(xc, [768], wc, bc, 1e-12),
                               (xc, wc, bc), torch.from_numpy(gr))
    for a, r in zip(got, want):
        torch.testing.assert_close(a.cpu(), r, **CARD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FORMS))
def test_functional_layer_norm_launches_the_kernel_in_every_form(cuda, form):
    """No form of ``F.layer_norm`` runs plain ops on the card: each
    launches ``layer_norm`` once and agrees with the CPU."""
    with_w, with_b, n_axes = FORMS[form]
    x, _, _, _ = _inputs((2, 3, 768), seed=8)
    ns = list(x.shape[-n_axes:])
    rng = np.random.RandomState(9)
    kw = {}
    if with_w:
        kw["weight"] = torch.from_numpy(
            (1 + 0.3 * rng.randn(*ns)).astype(np.float32))
    if with_b:
        kw["bias"] = torch.from_numpy(
            (0.5 * rng.randn(*ns)).astype(np.float32))
    reset_launch_counts()
    got = PF.layer_norm(torch.from_numpy(x).to(cuda), ns, epsilon=1e-5,
                        **{k: v.to(cuda) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert launch_counts["layer_norm"] == 1
    want = PF.layer_norm(torch.from_numpy(x), ns, epsilon=1e-5, **kw)
    torch.testing.assert_close(got.cpu(), want, **CARD_TOL[torch.float32])
