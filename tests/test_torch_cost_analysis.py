"""``TrainStep.cost_analysis`` / ``memory_analysis`` and ``paddle.flops``
against the reference's (XLA's cost model and ``CompiledMemoryStats`` of
the lowered step; the port traces one step without data).

The port counts the matrix products of forward and backward, 2 FLOPs a
multiply-add, the attention products in full (forward Q K^T and P V, the
backward's five); on tiny Llama that equals the analytic count exactly,
and it lies within [0.85, 1] of the reference's count, which also counts
elementwise work and the update (a divergence ROADMAP.md records).
``argument_size_in_bytes`` (parameters, buffers, AdamW moments and step
counters, batch, learning rate) holds to the reference's within 1 %;
``temp_size_in_bytes`` grows with the sequence and falls with recompute.
Neither call moves a parameter, a moment, a random stream or a launch
counter.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import launch_counts
from paddle_tpu_torch.kernels.attention import flash_attention_bshd
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import Layer, Linear
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer.fused import dispatch_counts

# the reference's cost_analysis()["flops"] on tiny Llama, AdamW, ids [2, S]
REF_FLOPS = {16: 78_743_360, 64: 313_246_720}


def _ids(s, b=2):
    return np.random.RandomState(0).randint(0, 256, (b, s)).astype(np.int64)


def _llama_step(use_recompute=False):
    model = LlamaForCausalLM(LlamaConfig.tiny(use_recompute=use_recompute),
                             device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    crit = LlamaPretrainingCriterion()
    return model, TrainStep(model, opt, lambda lg, lb: crit(lg, lb))


def _llama_products(cfg, b, s):
    """FLOPs of tiny Llama's products in one step: every projection and
    the head forward, twice that backward (dX and dW), and per layer the
    attention's 2 forward and 5 backward [S, S] x D products."""
    t, h, v = b * s, cfg.hidden_size, cfg.vocab_size
    hd = h // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * hd
    per_layer = 2 * t * h * (2 * h + 2 * kv) + 3 * 2 * t * h * \
        cfg.intermediate_size
    linear = cfg.num_hidden_layers * per_layer + 2 * t * h * v
    attn = 2 * b * cfg.num_attention_heads * s * s * hd
    return 3 * linear + cfg.num_hidden_layers * (2 + 5) * attn


def test_linear_step_flops_scale_with_the_batch():
    """The reference's ``TestCostAnalysis``: 4x the batch, 2.5-6x the
    FLOPs."""
    def flops_at(batch):
        pt.seed(0)
        net = pt.nn.Linear(32, 32, bias_attr=False, device="cpu")
        opt = SGD(0.1, parameters=net.parameters())
        step = TrainStep(net, opt, lambda p, t: ((p - t) ** 2).mean())
        x = torch.zeros(batch, 32)
        return float(step.cost_analysis(x, x)["flops"])
    f8, f32 = flops_at(8), flops_at(32)
    assert f8 > 0
    assert 2.5 < f32 / f8 < 6, (f8, f32)
    assert f8 == 2 * 2 * 8 * 32 * 32       # the forward and dW products


@pytest.mark.parametrize("s", [16, 64])
def test_llama_flops_are_its_products(s):
    model, step = _llama_step()
    got = step.cost_analysis(_ids(s), _ids(s))["flops"]
    assert got == _llama_products(model.config, 2, s)
    assert 0.85 <= got / REF_FLOPS[s] <= 1.0, got / REF_FLOPS[s]


def test_llama_flops_against_the_live_reference():
    import paddle_tpu as paddle
    from paddle_tpu.jit.bridge import TrainStep as RefStep
    from paddle_tpu.models import LlamaConfig as RCfg
    from paddle_tpu.models import LlamaForCausalLM as RModel
    from paddle_tpu.models import LlamaPretrainingCriterion as RCrit
    paddle.seed(0)
    ref = RModel(RCfg.tiny())
    crit = RCrit()
    rstep = RefStep(ref, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=ref.parameters()),
        lambda lg, lb: crit(lg, lb))
    _, step = _llama_step()
    ids = _ids(16)
    assert float(rstep.cost_analysis(ids, ids)["flops"]) == REF_FLOPS[16]
    rmem = rstep.memory_analysis(ids, ids)
    mem = step.memory_analysis(ids, ids)
    for field in ("generated_code_size_in_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "alias_size_in_bytes",
                  "temp_size_in_bytes", "host_generated_code_size_in_bytes",
                  "host_argument_size_in_bytes", "host_output_size_in_bytes",
                  "host_alias_size_in_bytes", "host_temp_size_in_bytes",
                  "peak_memory_in_bytes"):
        assert isinstance(getattr(mem, field), int), field
        assert hasattr(rmem, field), field
    assert abs(mem.argument_size_in_bytes / rmem.argument_size_in_bytes
               - 1) <= 0.01
    assert mem.alias_size_in_bytes == rmem.alias_size_in_bytes


def test_argument_bytes_are_the_references():
    _, step = _llama_step()
    mem = step.memory_analysis(_ids(16), _ids(16))
    assert abs(mem.argument_size_in_bytes / 4_792_416 - 1) <= 0.01
    assert mem.output_size_in_bytes == 4 + mem.alias_size_in_bytes
    assert mem.peak_memory_in_bytes == mem.argument_size_in_bytes + \
        mem.temp_size_in_bytes


def test_temp_grows_with_the_sequence_and_falls_with_recompute():
    _, step = _llama_step()
    t16 = step.memory_analysis(_ids(16), _ids(16)).temp_size_in_bytes
    t64 = step.memory_analysis(_ids(64), _ids(64)).temp_size_in_bytes
    assert 0 < t16 < t64
    _, rstep = _llama_step(use_recompute=True)
    r64 = rstep.memory_analysis(_ids(64), _ids(64)).temp_size_in_bytes
    assert r64 < t64
    # recompute runs the layers' forward products again (up to the last
    # product each layer's backward needs: checkpoint stops early)
    plain = step.cost_analysis(_ids(64), _ids(64))["flops"]
    again = rstep.cost_analysis(_ids(64), _ids(64))["flops"]
    cfg = rstep._model.config
    layers_fwd = (_llama_products(cfg, 2, 64)
                  - 3 * 2 * 2 * 64 * cfg.hidden_size * cfg.vocab_size) / 3
    assert plain < again < plain + layers_fwd


class _Dropout(Layer):
    """Attention with attention dropout, then hidden dropout: both random
    streams draw while it runs."""

    def __init__(self):
        super().__init__()
        self.qkv = Linear(64, 192, device="cpu")
        self.out = Linear(64, 8, device="cpu")

    def forward(self, x):
        q, k, v = (t.reshape(2, 16, 4, 16).contiguous()
                   for t in self.qkv(x).chunk(3, -1))
        a = flash_attention_bshd(q, k, v, dropout_p=0.3, is_causal=True)
        return self.out(PF.dropout(a.reshape(2, 16, 64), 0.2,
                                   training=True))


def _dropout_run(analyse):
    """Two steps of the dropout model from ``seed(4)``, the analyses
    between them when ``analyse``: (second loss, the state before the
    analyses, the state after them)."""
    pt.seed(4)
    model = _Dropout()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    step = TrainStep(model, opt, lambda y, t: ((y - t) ** 2).mean())
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 64)
                         .astype(np.float32))
    t = torch.zeros(2, 16, 8)
    step(x, t)                              # moments are not zero

    def snap():
        return ([p.detach().clone() for p in model.parameters()],
                [v.clone() for st in step.opt_state for v in st.values()],
                prandom.get_rng_state(), torch.get_rng_state(),
                dict(launch_counts), dict(dispatch_counts))
    before = snap()
    if analyse:
        assert step.cost_analysis(x, t)["flops"] > 0
        assert step.memory_analysis(x, t).temp_size_in_bytes > 0
    after = snap()
    return step(x, t), before, after


def test_analyses_change_no_state():
    loss, before, after = _dropout_run(True)
    (p0, s0, rng0, trng0, c0, d0), (p1, s1, rng1, trng1, c1, d1) = \
        before, after
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert rng1["draws"] == rng0["draws"] and rng1["seed"] == rng0["seed"]
    for k in ("attn", "gen"):
        assert torch.equal(rng1[k], rng0[k]), k
    assert rng1["devices"].keys() == rng0["devices"].keys()
    for d in rng1["devices"]:
        assert torch.equal(rng1["devices"][d], rng0["devices"][d])
    assert torch.equal(trng1, trng0) and c1 == c0 and d1 == d0
    # and the next real step draws what it would have drawn
    assert torch.equal(loss, _dropout_run(False)[0])


def test_flops_of_a_linear_equal_the_references():
    import paddle_tpu as paddle
    lin = pt.nn.Linear(32, 32, device="cpu")
    got = pt.flops(lin, input_size=[8, 32])
    assert got == paddle.flops(paddle.nn.Linear(32, 32),
                               input_size=[8, 32]) == 16384
    assert lin.training                    # put back after the count


def test_flops_counts_the_llama_forward():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    got = pt.flops(model, inputs=torch.from_numpy(_ids(16)))
    cfg = model.config
    fwd_only = _llama_products(cfg, 2, 16)
    t, h = 32, cfg.hidden_size
    hd = h // cfg.num_attention_heads
    linear = cfg.num_hidden_layers * (
        2 * t * h * 4 * h + 3 * 2 * t * h * cfg.intermediate_size) \
        + 2 * t * h * cfg.vocab_size
    attn = cfg.num_hidden_layers * 2 * 2 * 2 * cfg.num_attention_heads \
        * 16 * 16 * hd
    assert got == linear + attn < fwd_only
