"""The port's training path against the JAX reference: loss, criterion,
LR schedule, AdamW (with and without master weights), gradient clipping,
the train step's anomaly guard, checkpointing, and the whole slice — the
reference's ``Trainer`` (Pallas kernels in interpret mode or its XLA
path) against the port's ``Trainer`` on the CPU, on a tiny Llama loaded
with the same weights and fed the same seeded token ids.

f32 tolerance: atol = rtol = 1e-5 unless a test says otherwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import get_flags, set_flags

from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.distributed import VerifiedCheckpointer
from paddle_tpu_torch.framework import flags as port_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay
from paddle_tpu_torch.optimizer.optimizer import Adam
from paddle_tpu_torch.trainer import (AnomalousTrainingError, Trainer,
                                      TrainingArguments, device_peak_flops)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(params=[False, True], ids=["xla", "pallas_interpret"])
def ref_mode(request):
    """The reference through its XLA path, or through its Pallas kernels
    in interpret mode (flags restored afterwards)."""
    if not request.param:
        yield "xla"
        return
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        yield "pallas_interpret"
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})


def _ref_tensor(a, grad=False):
    t = paddle.to_tensor(a)
    t.stop_gradient = not grad
    return t


# --------------------------------------------------------------- loss --

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_reference(reduction):
    """Ignored rows (label -100) give 0 and leave the mean's denominator;
    values and logits gradients agree."""
    import paddle_tpu.nn.functional as RF
    rng = np.random.RandomState(0)
    x = rng.randn(7, 11).astype(np.float32)
    lab = rng.randint(0, 11, 7).astype(np.int64)
    lab[[1, 4]] = -100
    rx = _ref_tensor(x, grad=True)
    want = RF.cross_entropy(rx, _ref_tensor(lab), reduction=reduction)
    want.sum().backward()
    xt = torch.from_numpy(x).requires_grad_()
    got = PF.cross_entropy(xt, torch.from_numpy(lab), reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want.numpy()), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rx.grad.numpy()),
                               **TOL)
    if reduction == "none":
        assert not got[[1, 4]].any()


def test_cross_entropy_out_of_range_label_is_nan():
    import paddle_tpu.nn.functional as RF
    x = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    lab = np.array([2, 5, -100], np.int64)
    want = np.asarray(RF.cross_entropy(_ref_tensor(x), _ref_tensor(lab),
                                       reduction="none").numpy())
    got = PF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                           reduction="none").numpy()
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], **TOL)
    assert np.isnan(float(PF.cross_entropy(torch.from_numpy(x),
                                           torch.from_numpy(lab))))


def test_cross_entropy_neg_inf_logit_diverges_from_reference():
    """A known divergence, kept on purpose: a -inf logit gives the
    reference NaN (its hard-label path sums one_hot * log_softmax, and
    0 * -inf is NaN, in any class of the row), while the port gathers the
    label's log-probability and stays finite, as upstream Paddle's kernel
    does."""
    import paddle_tpu.nn.functional as RF
    x = np.array([[0.0, -np.inf, 1.0], [2.0, 0.5, -np.inf]], np.float32)
    lab = np.array([0, 1], np.int64)
    want = np.asarray(RF.cross_entropy(_ref_tensor(x), _ref_tensor(lab),
                                       reduction="none").numpy())
    got = PF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                           reduction="none").numpy()
    assert np.isnan(want).all()
    np.testing.assert_allclose(got, [1.3132616, 1.7014132], **TOL)


def test_pretraining_criterion_matches_reference():
    from paddle_tpu.models import LlamaPretrainingCriterion as RefCrit
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 6, 13).astype(np.float32)
    labels = rng.randint(0, 13, (2, 6)).astype(np.int64)
    labels[0, 3] = -100
    want = float(RefCrit()(_ref_tensor(logits), _ref_tensor(labels)))
    got = float(LlamaPretrainingCriterion()(torch.from_numpy(logits),
                                            torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, **TOL)


def test_train_and_eval_forward_agree():
    """No dropout on the Llama path: train() and eval() give one forward."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    ids = torch.randint(0, 256, (2, 9), generator=torch.Generator()
                        .manual_seed(1))
    with torch.no_grad():
        a = model.train()(ids)
        b = model.eval()(ids)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


# ----------------------------------------------------- LR and optimizer --

def test_cosine_annealing_matches_reference():
    from paddle_tpu.optimizer.lr import CosineAnnealingDecay as Ref
    ref, port = Ref(3e-4, T_max=7, eta_min=1e-5), \
        CosineAnnealingDecay(3e-4, T_max=7, eta_min=1e-5)
    for _ in range(10):
        assert port() == pytest.approx(ref(), rel=1e-12)
        ref.step()
        port.step()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Five AdamW steps (decay, and a parameter excluded from it) on the
    reference's functional update and the port's: parameters, moments
    and int32 steps agree; bf16 parameters carry f32 master weights and
    are the master cast down."""
    import jax.numpy as jnp
    from paddle_tpu.optimizer import AdamW as RefAdamW
    rng = np.random.RandomState(3)
    shapes = {"w": (5, 7), "b": (7,)}
    init = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(5)]
    tdt = getattr(torch, dtype)
    names = list(shapes)
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              apply_decay_param_fun=lambda n: n != "b")
    ref = RefAdamW(parameters=[], **kw)
    rp = [jnp.asarray(init[n], getattr(jnp, dtype)) for n in names]
    rs = ref._fn_init_all(rp, names)
    port_p = [torch.nn.Parameter(torch.from_numpy(init[n]).to(tdt))
              for n in names]
    port = AdamW(parameters=port_p, **kw)
    for g in grads:
        rg = [jnp.asarray(g[n], getattr(jnp, dtype)) for n in names]
        rp, rs = ref._fn_apply_all(rp, rg, rs, jnp.float32(1e-2), names)
        port.apply_gradients(port_p, [torch.from_numpy(g[n]).to(tdt)
                                      for n in names],
                             port._lr_operand(torch.device("cpu")), names)
    for p, a, st in zip(port_p, rp, rs):
        pst = port._state_of(p)
        assert set(pst) == set(st)
        assert int(pst["step"]) == int(st["step"]) == 5
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(pst[k].numpy(), np.asarray(st[k]),
                                       **TOL)
        if dtype == "bfloat16":
            assert pst["master_weight"].dtype == torch.float32
            np.testing.assert_allclose(pst["master_weight"].numpy(),
                                       np.asarray(st["master_weight"]),
                                       **TOL)
            assert torch.equal(p.detach(), pst["master_weight"].to(tdt))
        else:
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                       **TOL)


def test_adam_coupled_decay_and_state_dict_roundtrip():
    """Adam folds weight_decay into the gradient (the reference's
    coupled L2); state_dict / set_state_dict restore a fresh optimizer."""
    import jax.numpy as jnp
    from paddle_tpu.optimizer import Adam as RefAdam
    rng = np.random.RandomState(4)
    w0, g = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    ref = RefAdam(learning_rate=0.1, parameters=[], weight_decay=0.5)
    rp, rs = [jnp.asarray(w0)], ref._fn_init_all([jnp.asarray(w0)], ["w"])
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Adam(learning_rate=0.1, parameters=[p], weight_decay=0.5)
    for _ in range(2):
        rp, rs = ref._fn_apply_all(rp, [jnp.asarray(g)], rs,
                                   jnp.float32(0.1), ["w"])
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp[0]), **TOL)
    sd = opt.state_dict()
    assert set(sd) == {"param0_moment1", "param0_moment2", "param0_step"}
    fresh = Adam(learning_rate=0.1, parameters=[p], weight_decay=0.5)
    fresh.set_state_dict(sd)
    for k, v in fresh._state_of(p).items():
        assert torch.equal(v, opt._state_of(p)[k])


def test_global_norm_clip_matches_reference():
    import jax.numpy as jnp
    from paddle_tpu.jit.bridge import _clip_grads_functional
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as RefClip
    from paddle_tpu.nn.clip import ClipGradByNorm as RefNorm
    from paddle_tpu.nn.clip import ClipGradByValue as RefValue
    rng = np.random.RandomState(5)
    gs = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    cases = [(RefClip(1.0), ClipGradByGlobalNorm(1.0)),    # clips
             (RefClip(100.0), ClipGradByGlobalNorm(100.0)),  # leaves as is
             (RefNorm(1.5), ClipGradByNorm(1.5)),
             (RefValue(0.5), ClipGradByValue(0.5))]
    for ref, port in cases:
        want = _clip_grads_functional([jnp.asarray(g) for g in gs], ref)
        got = port.clip_grads([torch.from_numpy(g) for g in gs])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the eager form over (param, grad) pairs keeps None gradients
    p = torch.zeros(1)
    out = ClipGradByGlobalNorm(1.0)([(p, None), (p, torch.full((3,), 9.0))])
    assert out[0][1] is None
    np.testing.assert_allclose(float(out[1][1].norm()), 1.0, rtol=1e-6)


# ------------------------------------------------------------ train step --

def _tiny(seed=0, **kw):
    return LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu") \
        .init_weights(torch.Generator().manual_seed(seed))


def _snapshot(model, opt):
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = {n: {k: v.clone() for k, v in opt._state_of(p).items()}
             for n, p in model.named_parameters()}
    return params, state


def test_train_step_guard_keeps_state_on_nan_loss():
    """A NaN loss leaves every parameter, master weight and moment
    bit for bit; the next finite step moves them."""
    model = _tiny(dtype="bfloat16")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    crit = LlamaPretrainingCriterion()
    poison = {"on": False}

    def loss_fn(logits, labels):
        loss = crit(logits, labels)
        return loss * float("nan") if poison["on"] else loss
    step = TrainStep(model, opt, loss_fn)
    ids = np.random.RandomState(6).randint(0, 256, (2, 12))
    step(ids, ids)
    before = _snapshot(model, opt)
    poison["on"] = True
    assert torch.isnan(step(ids, ids))
    after = _snapshot(model, opt)
    for n in before[0]:
        assert torch.equal(before[0][n], after[0][n]), n
        for k in before[1][n]:
            assert torch.equal(before[1][n][k], after[1][n][k]), (n, k)
    assert int(after[1]["lm_head.weight"]["step"]) == 1
    poison["on"] = False
    step(ids, ids)
    assert not torch.equal(before[0]["lm_head.weight"],
                           model.lm_head.weight.detach())


# --------------------------------------------------------- checkpoints --

def test_checkpointer_verifies_and_falls_back(tmp_path):
    ck = VerifiedCheckpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"w": torch.full((3,), float(step),
                                       dtype=torch.bfloat16),
                       "n": {"t": torch.tensor(step, dtype=torch.int32)}},
                meta={"k": step})
    assert ck.steps() == [2, 3]
    tree, meta = ck.restore(3)
    assert tree["w"].dtype == torch.bfloat16 and float(tree["w"][0]) == 3
    assert int(tree["n"]["t"]) == 3 and meta == {"k": 3}
    victim = next((tmp_path / "3").glob("a*.bin"))
    data = victim.read_bytes()
    victim.write_bytes(data[:-1] + bytes([data[-1] ^ 0xFF]))
    assert ck.verify(3)[0] is False and ck.latest_verified() == 2
    step, tree, _ = ck.restore_latest()
    assert step == 2 and float(tree["w"][0]) == 2
    with pytest.raises(IOError):
        ck.restore(3)


# ------------------------------------------------------ the whole slice --

B, S = 2, 16


def _data(start_step):
    def gen():
        step = start_step
        while True:
            ids = np.random.RandomState(step).randint(0, 256, (B, S))
            yield ids.astype(np.int64), ids.astype(np.int64)
            step += 1
    return gen()


def _ref_data(start_step):
    it = _data(start_step)
    while True:
        a, b = next(it)
        yield paddle.to_tensor(a), paddle.to_tensor(b)


# AdamW's first update is lr * g / (|g| + eps): its slope at g ~ 0 is
# lr / eps, so f32 rounding differences between two backends' gradients
# (~1e-10) move weights by up to lr / eps * 1e-10. eps = 1e-6 (and a
# 1e-3 lr) keeps that below 1e-7 for the 1e-5 weight tolerance; at the
# default 1e-8 a few near-zero-gradient weights differ by ~2e-5.
OPT = dict(learning_rate=1e-3, epsilon=1e-6, weight_decay=0.1)


def _port_trainer(sd, out_dir, max_steps, save_steps, **kw):
    port = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_reference_state_dict(port, sd)
    crit = LlamaPretrainingCriterion()
    opt = AdamW(parameters=port.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **OPT)
    args = TrainingArguments(output_dir=str(out_dir), max_steps=max_steps,
                             logging_steps=1, save_steps=save_steps)
    return port, Trainer(port, opt, lambda lg, lb: crit(lg, lb), args,
                         _data, tokens_per_batch=B * S)


@pytest.mark.parametrize("cfg", [{}, {"num_attention_heads": 2,
                                      "num_key_value_heads": 1}],
                         ids=["mha_d32", "gqa_d64"])
def test_trainer_matches_reference_trainer(ref_mode, cfg, tmp_path):
    """4 AdamW steps with global-norm clipping: per-step losses and the
    final weights agree with the reference Trainer's. With head_dim 64
    and Pallas interpret the reference's attention runs its flash
    forward and backward kernels."""
    from paddle_tpu.models import LlamaConfig as RefConfig
    from paddle_tpu.models import LlamaForCausalLM as RefLlama
    from paddle_tpu.models import LlamaPretrainingCriterion as RefCrit
    from paddle_tpu.trainer import Trainer as RefTrainer
    from paddle_tpu.trainer import TrainingArguments as RefArgs
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(**cfg))
    sd = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    crit = RefCrit()
    ropt = paddle.optimizer.AdamW(
        parameters=ref.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **OPT)
    want = RefTrainer(ref, ropt, lambda lg, lb: crit(lg, lb),
                      RefArgs(output_dir=str(tmp_path / "ref"), max_steps=4,
                              logging_steps=1, save_steps=100),
                      _ref_data).train()
    port, trainer = _port_trainer(sd, tmp_path / "port", 4, 100, **cfg)
    got = trainer.train()
    assert got["final_step"] == 4
    np.testing.assert_allclose([r["loss"] for r in got["logs"]],
                               [r["loss"] for r in want["logs"]],
                               rtol=1e-5)
    ref_sd = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    for k, a in export_reference_state_dict(port).items():
        np.testing.assert_allclose(a, ref_sd[k], err_msg=k, atol=1e-5)


def test_trainer_resume_equals_uninterrupted(tmp_path):
    """A run stopped after a step-2 checkpoint and resumed by a fresh
    Trainer (fresh weights, fresh optimizer) reaches the uninterrupted
    run's step-3 and step-4 losses and weights exactly."""
    paddle_free = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu") \
        .init_weights(torch.Generator().manual_seed(3))
    sd = export_reference_state_dict(paddle_free)
    full, tr = _port_trainer(sd, tmp_path / "a", 4, 100)
    ref = tr.train()
    _, tr = _port_trainer(sd, tmp_path / "b", 2, 2)
    assert tr.train()["final_step"] == 2
    fresh = {k: np.zeros_like(v) for k, v in sd.items()}
    resumed, tr = _port_trainer(fresh, tmp_path / "b", 4, 100)
    res = tr.train()
    assert res["start_step"] == 2
    assert [r["loss"] for r in res["logs"]] == \
        [r["loss"] for r in ref["logs"][2:]]
    for (n, a), b in zip(full.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n


def test_trainer_resume_refuses_another_optimizer(tmp_path):
    sd = export_reference_state_dict(_tiny())
    _, tr = _port_trainer(sd, tmp_path, 1, 1)
    tr.train()
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    # multi-precision off and a bf16 model: no master weights, so the
    # optimizer state has another structure
    port = port.to(torch.bfloat16)
    opt = AdamW(parameters=port.parameters(), multi_precision=False)
    crit = LlamaPretrainingCriterion()
    tr = Trainer(port, opt, lambda lg, lb: crit(lg, lb),
                 TrainingArguments(output_dir=str(tmp_path), max_steps=2),
                 _data)
    with pytest.raises(RuntimeError, match="optimizer state structure"):
        tr.train()


def test_trainer_aborts_after_consecutive_anomalies(tmp_path, monkeypatch):
    monkeypatch.setattr(port_flags._REGISTRY["max_anomalous_steps"], "value",
                        2)
    model = _tiny()
    opt = AdamW(parameters=model.parameters())
    tr = Trainer(model, opt, lambda lg, lb: lg.sum() * float("nan"),
                 TrainingArguments(output_dir=str(tmp_path), max_steps=5,
                                   logging_steps=1), _data)
    with pytest.raises(AnomalousTrainingError):
        tr.train()
    assert device_peak_flops() == 1e12    # no card here


def test_export_reference_state_dict_roundtrip():
    model = _tiny(seed=4, num_key_value_heads=2)
    sd = export_reference_state_dict(model)
    assert sd["lm_head.weight"].shape == (128, 256)       # [in, out]
    other = load_reference_state_dict(
        LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2),
                         device="cpu"), sd)
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
