"""``jit.TrainStep`` as one CUDA graph per batch signature, and the
attention-dropout seed slots it refills before each replay.

CPU cases: a seed slot (an int32 [2] tensor) gives the plain versions
the reference's ``dropout_keep_mask`` pattern for the same two words; the
seeded eager patterns (attention dropout through ``flash_attention_bshd``
and elementwise dropout) are pinned by SHA-256 to the bytes they had
before the slots; ``batch_signature`` equals the reference's
``_ensure_compiled`` key; a CPU ``TrainStep`` captures nothing, updates
the state in place (the per-parameter path too) and keeps the loss
scaler's state in tensors of its own; ``get_rng_state`` carries the
attention draw count.

The ``cuda`` cases hold the captured step (first call eager and captured,
later calls replayed) to the step run op by op (``TrainStep._eager``) bit
for bit over 4 steps, losses, parameters, moments and gradients, with
equal kernel launches: a small bf16 decoder with attention and hidden
dropout, f16 O2 with a ``GradScaler`` and an injected overflow, recompute,
``FLAGS_anomaly_guard`` with a NaN loss, a cosine LR schedule, a rebound
parameter (re-captures), an in-place ``set_state_dict`` (replays) and a
``Trainer`` resume. They skip without a card; run them with
``python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py``.
"""
import hashlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.bridge import batch_signature
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.attention import (_dropout_mult,
                                                dropout_keep_mask,
                                                flash_attention_bshd,
                                                flash_attention_bwd_plain,
                                                flash_attention_plain)
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import Layer, Linear
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.kernels.norm import fused_rms_norm
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay

SEEDS = [(-5, 7), (123456789, -2 ** 31), (2 ** 31 - 1, 0)]


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ----------------------------------------------------------------- slots --

@pytest.mark.parametrize("seeds", SEEDS)
def test_slot_gives_the_references_keep_pattern(seeds):
    import jax.numpy as jnp
    from paddle_tpu.kernels import attention as RA
    p, b, h, sq, sk = 0.3, 2, 3, 40, 70
    slot = torch.tensor(seeds, dtype=torch.int32)
    got = _dropout_mult(b, h, sq, sk, p, slot, "cpu") != 0
    rows = np.arange(b * h, dtype=np.int32).reshape(b, h, 1, 1)
    want = RA.dropout_keep_mask(
        jnp.arange(sq, dtype=jnp.int32)[:, None],
        jnp.arange(sk, dtype=jnp.int32)[None, :], jnp.asarray(rows),
        seeds[0], seeds[1], sq, sk, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the two words given as ints take the same pattern
    assert torch.equal(got, _dropout_mult(b, h, sq, sk, p, seeds, "cpu") != 0)
    assert torch.equal(got[0, 0], dropout_keep_mask(
        torch.arange(sq)[:, None], torch.arange(sk)[None, :], 0, seeds[0],
        seeds[1], p))


def test_plain_versions_take_a_slot():
    rng = np.random.RandomState(1)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 16, 4, 64).astype(np.float32))
                  for _ in range(4))
    slot = torch.tensor(SEEDS[0], dtype=torch.int32)
    out_s, lse = flash_attention_plain(q, k, v, 0.125, True, return_lse=True,
                                       dropout_p=0.2, seeds=slot)
    out_w = flash_attention_plain(q, k, v, 0.125, True, dropout_p=0.2,
                                  seeds=SEEDS[0])
    assert torch.equal(out_s, out_w)
    grads_s = flash_attention_bwd_plain(q, k, v, out_s, lse, g, 0.125, True,
                                        dropout_p=0.2, seeds=slot)
    grads_w = flash_attention_bwd_plain(q, k, v, out_s, lse, g, 0.125, True,
                                        dropout_p=0.2, seeds=SEEDS[0])
    assert all(torch.equal(a, b) for a, b in zip(grads_s, grads_w))


def test_seeded_eager_patterns_are_unchanged():
    """SHA-256 of the bytes the parent commit gave (host-drawn words by
    value): three attention calls with dropout, their gradients, and two
    elementwise dropouts, each after ``seed(7)``."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 4, 64).astype(np.float32))
               .requires_grad_() for _ in range(3))
    prandom.seed(7)
    outs = [flash_attention_bshd(q, k, v, dropout_p=0.3, is_causal=True)
            for _ in range(3)]
    sum(o.sum() for o in outs).backward()
    assert _digest(*outs, q.grad, k.grad, v.grad) == (
        "6d1017ef3d32c9bba489f3f44c736f6cef50f1e1c62e39b8031eaa19499d9ab8")
    prandom.seed(7)
    x = torch.ones(64, 32)
    assert _digest(PF.dropout(x, 0.3, training=True),
                   PF.dropout(x, 0.5, training=True)) == (
        "ced72575984d6a39c9d0e2c8aa2dbb55c5fc21a1ba8831300960a6f23238dfcb")


def test_rng_state_carries_the_draw_count():
    prandom.seed(3)
    state = prandom.get_rng_state()
    first = [prandom.dropout_seed_slot("cpu") for _ in range(2)]
    assert prandom.attention_draws() == state["draws"] + 2
    prandom.set_rng_state(state)
    again = [prandom.dropout_seed_slot("cpu") for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert prandom.attention_draws() == state["draws"] + 2
    # a replay's words are the eager calls' words
    prandom.set_rng_state(state)
    assert [tuple(int(x) for x in s) for s in first] == \
        [tuple(w) for w in prandom.dropout_words(2)]


# ------------------------------------------------------------ signature --

@pytest.mark.parametrize("kind", ["ids", "features", "mask"])
def test_signature_equals_the_references(kind):
    import paddle_tpu as paddle
    from paddle_tpu.jit.bridge import TrainStep as RefStep
    rng = np.random.RandomState(0)
    batch = {"ids": [rng.randint(0, 9, (2, 16)).astype(np.int64)] * 2,
             "features": [rng.randn(4, 8).astype(np.float32),
                          rng.randint(0, 3, (4,)).astype(np.int64)],
             "mask": [rng.randn(3, 5).astype(np.float32),
                      rng.rand(3, 5) > 0.5]}[kind]
    paddle.seed(0)
    lin = paddle.nn.Linear(4, 4)
    ref = RefStep(lin, paddle.optimizer.SGD(parameters=lin.parameters()),
                  lambda out, *lb: out.sum())
    want = ref._ensure_compiled(batch)[1]
    assert batch_signature([torch.from_numpy(a) for a in batch]) == want
    assert batch_signature(batch) == want


# ------------------------------------------------------------ CPU step --

def _tiny(seed=0, **kw):
    model = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    return model.init_weights(torch.Generator().manual_seed(seed))


def test_cpu_step_captures_nothing_and_updates_in_place():
    model = _tiny()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    crit = LlamaPretrainingCriterion()
    step = TrainStep(model, opt, lambda lg, lb: crit(lg, lb))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 16)))
    before = [t for st in step.opt_state for t in st.values()]
    gen = opt._state_gen
    losses = [float(step(ids, ids)) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert step.graph_stats == {"captures": 0, "replays": 0,
                                "recaptures": 0, "capture_s": 0.0}
    assert not step._graphs
    after = [t for st in step.opt_state for t in st.values()]
    assert all(a is b for a, b in zip(before, after)) and opt._state_gen == gen


@pytest.mark.parametrize("clip", [False, True])
def test_per_parameter_path_in_place_equals_rebinding(clip):
    """``apply_gradients(in_place=True)`` (the step's) gives the new
    tensors the default path binds, into the same tensors."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    models = [_tiny(), _tiny()]
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 16)))
    crit = LlamaPretrainingCriterion()
    opts = [AdamW(learning_rate=1e-2, parameters=m.parameters(),
                  grad_clip=ClipGradByGlobalNorm(0.5) if clip else None)
            for m in models]
    set_flags({"fused_optimizer": False})
    try:
        step = TrainStep(models[0], opts[0], lambda lg, lb: crit(lg, lb))
        held = [t for st in step.opt_state for t in st.values()]
        for _ in range(2):
            step(ids, ids)
            loss = crit(models[1](ids), ids)
            loss.backward()
            opts[1].step()
            opts[1].clear_grad()
    finally:
        set_flags({"fused_optimizer": True})
    assert all(a is b for a, b in zip(
        held, [t for st in step.opt_state for t in st.values()]))
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    for pa, pb in zip(models[0].parameters(), models[1].parameters()):
        sa, sb = opts[0]._state_of(pa), opts[1]._state_of(pb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_scaler_state_is_the_steps_own():
    model = _tiny()
    opt = SGD(learning_rate=1e-2, parameters=model.parameters())
    crit = LlamaPretrainingCriterion()
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    step = TrainStep(model, opt, lambda lg, lb: crit(lg, lb), scaler=scaler)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 16)))
    step(ids, ids)
    held = scaler._dev_state
    assert held is step._sc_state
    step(ids, ids)
    assert scaler._dev_state is held
    assert scaler.get_loss_scaling() == 2.0 ** 11     # two good steps
    scaler.load_state_dict({"scale": 8.0, "incr_count": 0,
                            "decr_count": 0})
    step(ids, ids)                  # from the host fields, in place
    assert scaler._dev_state is held and float(held[0]) == 8.0


# ------------------------------------------------------------------ card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


class _DropDecoder(Layer):
    """Two causal attention blocks with attention dropout and hidden
    dropout (both of the port's random streams), RMSNorm and a head."""

    def __init__(self, dev, dtype, vocab=128, hidden=128, heads=2):
        super().__init__()
        self.heads = heads
        self.emb = torch.nn.Embedding(vocab, hidden, device=dev, dtype=dtype)
        self.qkv = torch.nn.ModuleList(
            [Linear(hidden, 3 * hidden) for _ in range(2)])
        self.norm_w = torch.nn.Parameter(torch.ones(hidden, device=dev,
                                                    dtype=dtype))
        self.head = Linear(hidden, vocab)
        self.to(dev, dtype)

    def forward(self, ids):
        h = self.emb(ids)
        b, s, d = h.shape
        for lin in self.qkv:
            q, k, v = (t.reshape(b, s, self.heads, d // self.heads)
                       for t in lin(h).chunk(3, -1))
            a = PF.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                                is_causal=True)
            h = h + PF.dropout(a.reshape(b, s, d), 0.1, training=True)
        return self.head(fused_rms_norm(h, self.norm_w))


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), labels.reshape(-1))


def _card_llama(dev, dtype="bfloat16", seed=0, **kw):
    cfg = LlamaConfig.tiny(hidden_size=128, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=256,
                           dtype=dtype, **kw)
    return LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))


def _state(model, step):
    out = {f"p.{n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"g.{n}": p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None})
    for n, st in zip(step._p_names, step.opt_state):
        out.update({f"s.{n}.{k}": v.detach().clone() for k, v in st.items()})
    return out


def _run(make, batches, eager, between=None):
    """Build (model, step) with ``make()``, then one step per batch from
    ``prandom.seed(5)``: through graphs, or op by op with ``eager``.
    Returns (losses, state after each step, launches per step, step)."""
    prandom.seed(5)
    model, step = make()
    losses, states, launches = [], [], []
    for i, batch in enumerate(batches):
        if between is not None:
            between(i, model, step)
        reset_launch_counts()
        loss = (step._eager if eager else step)(*batch)
        torch.cuda.synchronize()
        launches.append({k: n for k, n in launch_counts.items() if n})
        losses.append(loss.detach().float().cpu())
        states.append(_state(model, step))
    return losses, states, launches, step


def _bits(t):
    """``t``'s bytes: equal bits, NaN payloads included."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_bitwise(make, batches, between=None, captures=1, recaptures=0):
    got = _run(make, batches, False, between)
    want = _run(make, batches, True, between)
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert torch.equal(_bits(a), _bits(b)), (i, a, b)
    for i, (sa, sb) in enumerate(zip(got[1], want[1])):
        assert sa.keys() == sb.keys(), i
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and \
                torch.equal(_bits(sa[k]), _bits(sb[k])), (i, k)
    assert got[2] == want[2]
    stats = got[3].graph_stats
    assert stats["captures"] == captures and \
        stats["recaptures"] == recaptures and \
        stats["replays"] == len(batches) - captures, stats
    assert want[3].graph_stats["captures"] == 0
    return got


def _ids(dev, seed, b=2, s=64, vocab=128):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g).to(dev)


@pytest.mark.cuda
def test_dropout_decoder_bf16_replays_bitwise(cuda):
    def make():
        model = _DropDecoder(cuda, torch.bfloat16)
        torch.manual_seed(0)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        return model, TrainStep(model, opt, _ce)
    batches = [(_ids(cuda, i),) * 2 for i in range(4)]
    got = _assert_bitwise(make, batches)
    assert got[2][1]["flash_fwd"] == 2 and got[2][1]["flash_bwd_dq"] == 2 \
        and got[2][1]["fused_update"] == 1


@pytest.mark.cuda
def test_f16_o2_scaler_with_an_overflow_replays_bitwise(cuda):
    """Step 3's batch carries a multiplier that overflows f16 in the
    logits: that step skips the update and halves the scale."""
    def make():
        model = _card_llama(cuda, "float32")
        amp.decorate(model, level="O2", dtype="float16")
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    multi_precision=True)
        crit = LlamaPretrainingCriterion()

        def loss_fn(logits, labels, poison):
            return crit(logits * poison.to(logits.dtype), labels)
        return _amp_wrap(model, TrainStep(
            model, opt, loss_fn,
            scaler=amp.GradScaler(init_loss_scaling=2.0 ** 15)))
    batches = [(_ids(cuda, i), _ids(cuda, i), torch.tensor(p, device=cuda))
               for i, p in enumerate([1.0, 1.0, 6e4, 1.0])]
    got = _assert_bitwise(make, batches)
    assert got[3]._scaler.get_loss_scaling() == 2.0 ** 14


def _amp_wrap(model, step):
    """(model, step) whose calls run under O2 f16 auto_cast."""

    class _Under:
        graph_stats = step.graph_stats
        opt_state = property(lambda self: step.opt_state)
        _p_names = step._p_names
        _scaler = step._scaler

        def __call__(self, *b):
            with amp.auto_cast(level="O2", dtype="float16"):
                return step(*b)

        def _eager(self, *b):
            with amp.auto_cast(level="O2", dtype="float16"):
                return step._eager(*b)
    return model, _Under()


@pytest.mark.cuda
def test_recompute_replays_bitwise(cuda):
    def make():
        model = _card_llama(cuda, use_recompute=True)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        crit = LlamaPretrainingCriterion()
        return model, TrainStep(model, opt, lambda lg, lb: crit(lg, lb))
    batches = [(_ids(cuda, i),) * 2 for i in range(4)]
    got = _assert_bitwise(make, batches)
    # the recomputed forward runs each layer's two norms and attention
    # again: 2 x (2 + 2) + 1 norms, 2 x 2 forwards
    assert got[2][1]["flash_fwd"] == 4 and got[2][1]["rms_norm"] == 9


@pytest.mark.cuda
def test_guard_with_a_nan_loss_replays_bitwise(cuda):
    def make():
        model = _card_llama(cuda)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        crit = LlamaPretrainingCriterion()
        return model, TrainStep(
            model, opt, lambda lg, lb, poison: crit(lg, lb) * poison)
    set_flags({"anomaly_guard": True})
    try:
        batches = [(_ids(cuda, i), _ids(cuda, i),
                    torch.tensor(float("nan") if i == 1 else 1.0,
                                 device=cuda)) for i in range(4)]
        got = _assert_bitwise(make, batches)
    finally:
        set_flags({"anomaly_guard": False})
    assert got[0][1].isnan()
    # the NaN step changed no parameter
    assert all(torch.equal(got[1][0][k], got[1][1][k])
               for k in got[1][0] if k.startswith("p."))


@pytest.mark.cuda
def test_cosine_schedule_replays_bitwise(cuda):
    def make():
        model = _card_llama(cuda)
        opt = AdamW(learning_rate=CosineAnnealingDecay(1e-2, T_max=4),
                    parameters=model.parameters())
        crit = LlamaPretrainingCriterion()
        return model, TrainStep(model, opt, lambda lg, lb: crit(lg, lb))

    def between(i, model, step):
        if i:
            step._opt._learning_rate.step()
    batches = [(_ids(cuda, 0),) * 2 for _ in range(4)]
    _assert_bitwise(make, batches, between)


@pytest.mark.cuda
def test_rebound_parameter_recaptures(cuda):
    def make():
        model = _card_llama(cuda)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        crit = LlamaPretrainingCriterion()
        return model, TrainStep(model, opt, lambda lg, lb: crit(lg, lb))

    def between(i, model, step):
        if i == 2:
            w = model.lm_head.weight
            w.data = w.data.clone()          # new storage, same Parameter
    batches = [(_ids(cuda, i),) * 2 for i in range(4)]
    _assert_bitwise(make, batches, between, captures=2, recaptures=1)


@pytest.mark.cuda
def test_in_place_load_replays(cuda):
    def make():
        model = _card_llama(cuda)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        crit = LlamaPretrainingCriterion()
        return model, TrainStep(model, opt, lambda lg, lb: crit(lg, lb))
    other = _card_llama(cuda, seed=9).state_dict()

    def between(i, model, step):
        if i == 2:
            missing, unexpected = model.set_state_dict(other)
            assert not missing and not unexpected
    batches = [(_ids(cuda, i),) * 2 for i in range(4)]
    _assert_bitwise(make, batches, between)


@pytest.mark.cuda
def test_trainer_resume_through_graphs(cuda, tmp_path):
    from paddle_tpu_torch.trainer import Trainer, TrainingArguments
    ids = _ids(cuda, 3)

    def trainer(out, steps, save):
        prandom.seed(5)
        model = _card_llama(cuda)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        crit = LlamaPretrainingCriterion()

        def data(start):
            while True:
                yield ids, ids
        t = Trainer(model, opt, lambda lg, lb: crit(lg, lb),
                    TrainingArguments(output_dir=str(out), max_steps=steps,
                                      logging_steps=1, save_steps=save),
                    data)
        return t, model
    t1, m1 = trainer(tmp_path / "a", 4, 100)
    t1.train()
    t2, _ = trainer(tmp_path / "b", 2, 2)
    t2.train()
    t3, m3 = trainer(tmp_path / "b", 4, 100)
    res = t3.train()
    assert res["start_step"] == 2
    assert t3._step_obj.graph_stats["captures"] == 1
    assert t1._step_obj.graph_stats["replays"] == 3
    for a, b in zip(m1.parameters(), m3.parameters()):
        assert torch.equal(a, b)
