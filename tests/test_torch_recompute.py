"""Activation recompute (``distributed.fleet.recompute`` and
``LlamaConfig.use_recompute``) on the CPU: bit for bit the run without
it, under ``amp`` too (the recomputed forward runs after ``auto_cast``
has exited) and with dropout (the port's own random streams are
replayed); and against the reference's ``recompute`` on the same
weights (f32, atol = rtol = 1e-5)."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import linear_weights, load_reference_state_dict
from paddle_tpu_torch.distributed.fleet import (recompute, recompute_hybrid,
                                                recompute_sequential)
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.kernels.attention import flash_attention_bshd
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as PF

TOL = dict(atol=1e-5, rtol=1e-5)


def _llama_grads(use_recompute, autocast, ids):
    model = LlamaForCausalLM(LlamaConfig.tiny(use_recompute=use_recompute),
                             device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    if autocast:
        amp.decorate(model, level="O2", dtype="float16")
    ctx = amp.auto_cast(level=autocast or "O1", dtype="float16",
                        enable=bool(autocast))
    with ctx:
        loss = LlamaPretrainingCriterion()(model(ids), ids)
    loss.backward()         # outside auto_cast, as a training loop does
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("autocast", [None, "O1", "O2"])
def test_llama_recompute_is_bitwise(autocast):
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 24)))
    loss0, g0 = _llama_grads(False, autocast, ids)
    loss1, g1 = _llama_grads(True, autocast, ids)
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert g0[n].dtype == g1[n].dtype and torch.equal(g0[n], g1[n]), n


def test_recompute_only_in_training_without_cache():
    model = LlamaForCausalLM(LlamaConfig.tiny(use_recompute=True),
                             device="cpu").eval()
    ids = torch.arange(8)[None]
    calls = []
    handle = torch.utils.checkpoint.checkpoint
    try:
        torch.utils.checkpoint.checkpoint = \
            lambda *a, **k: calls.append(1) or handle(*a, **k)
        with torch.no_grad():
            model(ids)
        assert not calls
        model.train()
        model(ids)
        assert len(calls) == 2
    finally:
        torch.utils.checkpoint.checkpoint = handle


class _DropBlock(torch.nn.Module):
    """Attention with attention dropout, then elementwise dropout: both of
    the port's random streams."""

    def __init__(self):
        super().__init__()
        self.qkv = Linear(32, 96)

    def forward(self, x):
        q, k, v = (t.reshape(2, 16, 4, 8).contiguous()
                   for t in self.qkv(x).chunk(3, -1))
        a = flash_attention_bshd(q, k, v, dropout_p=0.3, is_causal=True)
        return PF.dropout(a.reshape(2, 16, 32), p=0.2)


@pytest.mark.parametrize("preserve", [True, False])
def test_recompute_replays_dropout(preserve):
    """With preserve_rng_state (the default) the recomputed forward draws
    the first run's patterns, so the gradients are those of the run
    without recompute, and the live streams end where that run's do;
    without it the second run draws anew and the gradients differ."""
    torch.manual_seed(0)
    block = _DropBlock()
    x = torch.randn(2, 16, 32, requires_grad=True)

    def grads(fn):
        prandom.seed(7)
        out = fn(block, x)
        seeds_after = prandom.dropout_seeds()
        out.square().sum().backward()
        g = [x.grad.clone()] + [p.grad.clone() for p in block.parameters()]
        x.grad = None
        block.zero_grad()
        return out.detach(), g, seeds_after
    out0, g0, s0 = grads(lambda m, a: m(a))
    out1, g1, s1 = grads(lambda m, a: recompute(m, a,
                                                preserve_rng_state=preserve))
    assert torch.equal(out0, out1)
    if preserve:
        assert s1 == s0
        for a, b in zip(g0, g1):
            assert torch.equal(a, b)
    else:
        assert not all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_recompute_sequential_and_hybrid():
    torch.manual_seed(1)
    fs = [Linear(8, 8), torch.nn.Tanh(), Linear(8, 8), torch.nn.Tanh()]
    x = torch.randn(3, 8, requires_grad=True)
    plain = torch.nn.Sequential(*fs)(x)
    (gp,) = torch.autograd.grad(plain.sum(), x)
    seq = recompute_sequential({"segments": 2}, fs, x)
    (gs,) = torch.autograd.grad(seq.sum(), x)
    hyb = recompute_hybrid({}, torch.nn.Sequential(*fs), x)
    (gh,) = torch.autograd.grad(hyb.sum(), x)
    assert torch.equal(plain, seq) and torch.equal(plain, hyb)
    assert torch.equal(gp, gs) and torch.equal(gp, gh)


def test_llama_recompute_matches_reference():
    """The port's Llama with ``use_recompute`` against the reference's
    ``recompute`` (``jax.checkpoint``) over each of its decoder layers on
    the same weights: loss and every gradient. The reference's own
    ``use_recompute`` path cannot run: its ``recompute`` takes only tensor
    outputs and the layer returns (h, (k, v)), so each layer is wrapped to
    return h."""
    import paddle_tpu as paddle
    from paddle_tpu import models as RM
    from paddle_tpu.distributed.fleet.recompute import recompute as rrecompute
    from paddle_tpu.nn.layer_base import Layer

    class Wrap(Layer):
        def __init__(self, layer, cos, sin):
            super().__init__()
            self.layer, self.cos, self.sin = layer, cos, sin

        def forward(self, h):
            return self.layer(h, self.cos, self.sin)[0]
    paddle.seed(0)
    ref = RM.LlamaForCausalLM(RM.LlamaConfig.tiny())
    port = LlamaForCausalLM(LlamaConfig.tiny(use_recompute=True),
                            device="cpu")
    load_reference_state_dict(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
    ids = np.random.RandomState(2).randint(0, 256, (2, 16)).astype(np.int64)
    rids = paddle.to_tensor(ids)
    m = ref.llama
    h = m.embed_tokens(rids)
    cos, sin = m.rope_cos[0:16], m.rope_sin[0:16]
    for layer in m.layers:
        h = rrecompute(Wrap(layer, cos, sin), h)
    r_loss = RM.LlamaPretrainingCriterion(ref.config)(
        ref.lm_head(m.norm(h)), rids)
    r_loss.backward()
    loss = LlamaPretrainingCriterion()(port(torch.from_numpy(ids)),
                                       torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(r_loss.numpy()), **TOL)
    want = {n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()}
    lin = linear_weights(port)
    for n, p in port.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if n in lin else g, want[n],
                                   err_msg=n, **TOL)
