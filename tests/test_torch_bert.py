"""The port's BERT / ERNIE sequence-classification fine-tuning path
against the JAX reference, at tiny sizes with head_dim 64 (hidden 128,
2 heads), so that the reference's Pallas gate admits attention and its
dropout is the counter hash the port reproduces.

- Eval logits of ``BertForSequenceClassification`` and
  ``ErnieForSequenceClassification`` after ``convert``, with padding
  through ``attention_mask`` (BERT: additive -1e4; ERNIE: boolean).
- ``LinearWarmup(PolynomialDecay)`` values.
- Three steps of ``examples/bert_finetune.py``'s eager loop (AdamW with
  ``apply_decay_param_fun``, the schedule) on both packages: losses and
  weights. BERT runs with attention dropout 0.1 and hidden dropout 0;
  the reference runs through its Pallas kernels in interpret mode and
  gets the port's seed pairs through its ``dropout_seeds``, replaced
  inside the test only.
- ``nn.functional.dropout`` is held to statistics (keep rate within
  binomial bounds, the 1/(1-p) scale, ``downscale_in_infer``, ``axis``):
  the reference draws with ``jax.random``, which the port cannot match
  bit for bit.

f32 tolerance: atol = rtol = 1e-5.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.examples import bert_finetune as example
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.models import (BertConfig, BertForSequenceClassification,
                                     ErnieConfig,
                                     ErnieForSequenceClassification)
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer.lr import LinearWarmup, PolynomialDecay

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(vocab_size=100, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            max_position_embeddings=64)
B, S, STEPS = 2, 16, 3


@pytest.fixture()
def pallas_interpret():
    """The reference's Pallas kernels in interpret mode (flags restored
    afterwards)."""
    from paddle_tpu.framework.flags import get_flags, set_flags
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        yield
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})


def _pair(name, **cfg):
    """(reference model, port model on the CPU) with the reference's
    weights."""
    import paddle_tpu as paddle
    from paddle_tpu import models as RM
    paddle.seed(0)
    if name == "bert":
        ref = RM.BertForSequenceClassification(
            RM.BertConfig.tiny(num_labels=4, **TINY, **cfg))
        port = BertForSequenceClassification(
            BertConfig.tiny(num_labels=4, **TINY, **cfg), device="cpu")
    else:
        ref = RM.ErnieForSequenceClassification(
            RM.ErnieConfig.tiny(**TINY, **cfg), num_classes=4)
        port = ErnieForSequenceClassification(
            ErnieConfig.tiny(**TINY, **cfg), num_classes=4, device="cpu")
    sd = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_reference_state_dict(port, sd)
    return ref, port


def _batches(steps=STEPS, seed=0):
    return list(example.synthetic_batches(np.random.RandomState(seed),
                                          TINY["vocab_size"], B, S, 4, steps,
                                          min_len=S // 2))


@pytest.mark.parametrize("name", ["bert", "ernie"])
def test_eval_logits_match_reference(name, pallas_interpret):
    import paddle_tpu as paddle
    ref, port = _pair(name)
    ref.eval()
    port.eval()
    for ids, _, mask in _batches(2, seed=1):
        want = ref(paddle.to_tensor(ids),
                   attention_mask=paddle.to_tensor(mask)).numpy()
        with torch.no_grad():
            got = port(torch.from_numpy(ids),
                       attention_mask=torch.from_numpy(mask))
        assert got.shape == (B, 4)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # the padding is masked: changing padded ids leaves the logits
        ids2 = np.where(mask == 1, ids, (ids + 7) % TINY["vocab_size"])
        with torch.no_grad():
            again = port(torch.from_numpy(ids2),
                         attention_mask=torch.from_numpy(mask))
        torch.testing.assert_close(again, got, **TOL)


def test_schedule_matches_reference():
    from paddle_tpu.optimizer import lr as RL
    ref = RL.LinearWarmup(RL.PolynomialDecay(3e-5, 30), warmup_steps=3,
                          start_lr=0.0, end_lr=3e-5)
    port = LinearWarmup(PolynomialDecay(3e-5, 30), warmup_steps=3,
                        start_lr=0.0, end_lr=3e-5)
    for _ in range(40):
        assert port() == pytest.approx(ref(), rel=1e-12, abs=0)
        ref.step()
        port.step()
    cyc_r = RL.PolynomialDecay(1.0, 4, end_lr=0.1, power=2.0, cycle=True)
    cyc_p = PolynomialDecay(1.0, 4, end_lr=0.1, power=2.0, cycle=True)
    for _ in range(10):
        assert cyc_p() == pytest.approx(cyc_r(), rel=1e-12, abs=0)
        cyc_r.step()
        cyc_p.step()


def _ref_loop(ref, batches, lr, steps, epsilon):
    """The reference example's single-device loop (AdamW at
    ``epsilon``)."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as rnn
    opt = paddle.optimizer.AdamW(
        learning_rate=paddle.optimizer.lr.LinearWarmup(
            paddle.optimizer.lr.PolynomialDecay(lr, steps),
            warmup_steps=max(steps // 10, 1), start_lr=0.0, end_lr=lr),
        epsilon=epsilon, parameters=ref.parameters(), weight_decay=0.01,
        apply_decay_param_fun=lambda n: "norm" not in n and "bias" not in n)
    crit = rnn.CrossEntropyLoss()
    losses = []
    for ids, labels, mask in batches:
        logits = ref(paddle.to_tensor(ids),
                     attention_mask=paddle.to_tensor(mask))
        loss = crit(logits, paddle.to_tensor(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        opt._learning_rate.step()
        losses.append(float(loss.numpy()))
    return losses


@pytest.mark.parametrize("name, cfg", [
    ("bert", dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1)),
    ("ernie", dict(hidden_dropout_prob=0.0))])
def test_finetune_steps_match_reference(name, cfg, pallas_interpret,
                                        monkeypatch):
    """Three steps of the example's loop at the schedule of a 30-step run
    (lr 0, 1e-5, 2e-5) and lr 1e-3 (lr 0, 1e-3, 6.3e-4): losses and every
    weight to 1e-5; the reference consumes the port's seed pairs in the
    port's order.

    The key projection's bias has a gradient of exactly 0 in exact
    arithmetic (a softmax does not see a shift shared by a row's scores),
    so both backends hand Adam rounding noise, which its first steps,
    lr * g / (|g| + eps), turn into moves of either sign up to lr. So
    AdamW runs at eps 1e-6, not the example's 1e-8 (at 1e-8 and lr 3e-5
    these biases ended 1.2e-5 apart), and at lr 1e-3 they are held to
    their exact value 0 within 1e-4 on both sides instead of to each
    other (measured 1.8e-5 apart); every other tensor to 1e-5."""
    import paddle_tpu.kernels.attention as RA
    real = prandom.dropout_seeds
    for lr, steps in ((3e-5, 30), (1e-3, 3)):
        ref, port = _pair(name, **cfg)
        batches = _batches()
        seeds = []

        def record():
            seeds.append(real())
            return seeds[-1]
        monkeypatch.setattr(prandom, "dropout_seeds", record)
        opt = example.build_optimizer(port, lr, steps)
        opt.epsilon = 1e-6
        crit = CrossEntropyLoss()
        got = [float(example.train_step(port, opt, crit,
                                        *example.to_device(bt, "cpu"))
                     .detach()) for bt in batches]
        expect_draws = STEPS * TINY["num_hidden_layers"] if name == "bert" \
            else 0
        assert len(seeds) == expect_draws
        queue = list(seeds)

        def replay(key):
            import jax.numpy as jnp
            s0, s1 = queue.pop(0)
            return (jnp.zeros((1, 1, 128), jnp.int32)
                    .at[0, 0, 0].set(s0).at[0, 0, 1].set(s1))
        monkeypatch.setattr(RA, "dropout_seeds", replay)
        want = _ref_loop(ref, batches, lr, steps, epsilon=1e-6)
        assert not queue
        np.testing.assert_allclose(got, want, **TOL)
        ref_sd = {k: np.asarray(v.numpy())
                  for k, v in ref.state_dict().items()}
        for k, a in export_reference_state_dict(port).items():
            if lr > 1e-4 and k.endswith("self_attn.k_proj.bias"):
                assert np.abs(a).max() <= 1e-4, k
                assert np.abs(ref_sd[k]).max() <= 1e-4, k
                continue
            np.testing.assert_allclose(a, ref_sd[k], err_msg=k, **TOL)


def test_apply_decay_param_fun_sees_no_structured_names():
    """The example's ``"norm" not in n and "bias" not in n`` decays every
    tensor on both sides: the reference hands it ``p.name`` (None for
    every parameter, so ""), the port ``param<i>``."""
    ref, port = _pair("bert")
    assert all(not (getattr(p, "name", "") or "") for p in ref.parameters())
    opt = example.build_optimizer(port, 3e-5, 30)
    fn = opt._apply_decay_param_fun
    assert all(fn(n) for n in opt._param_names)


# ------------------------------------------------------------ dropout --

def test_dropout_statistics():
    prandom.seed(3)
    x = torch.ones(400, 500)
    n = x.numel()
    for p in (0.1, 0.5):
        y = PF.dropout(x, p, training=True)
        kept = y != 0
        rate = kept.float().mean().item()
        assert abs(rate - (1 - p)) <= 6 * (p * (1 - p) / n) ** 0.5
        torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                            1 / (1 - p)))
        down = PF.dropout(x, p, training=True, mode="downscale_in_infer")
        assert set(down.unique().tolist()) <= {0.0, 1.0}
        torch.testing.assert_close(
            PF.dropout(x, p, training=False, mode="downscale_in_infer"),
            x * (1 - p))
        assert PF.dropout(x, p, training=False) is x
    cols = PF.dropout(x, 0.5, axis=1)
    assert ((cols == 0).all(0) | (cols != 0).all(0)).all()
    assert 0 < (cols[0] == 0).sum() < 500
    assert not PF.dropout(x, 1.0).any()
    assert PF.dropout(x, 0.0) is x
    prandom.seed(3)
    a = PF.dropout(x, 0.5)
    prandom.seed(3)
    torch.testing.assert_close(PF.dropout(x, 0.5), a, atol=0, rtol=0)


def test_dropout_layers_follow_train_and_eval():
    _, port = _pair("bert")
    ids = torch.from_numpy(_batches(1)[0][0])
    port.eval()
    with torch.no_grad():
        a, b = port(ids), port(ids)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    port.train()
    with torch.no_grad():
        c, d = port(ids), port(ids)
    assert not torch.allclose(c, d)


# ------------------------------------------------------------ example --

def test_example_runs_and_returns_losses():
    res = example.main(["--smoke", "--device", "cpu", "--steps", "4",
                        "--batch", "2", "--seq", "16", "--min-len", "8"])
    assert len(res["losses"]) == 4 and len(res["step_s"]) == 4
    assert all(np.isfinite(res["losses"]))
    assert isinstance(res["model"], BertForSequenceClassification)
    res = example.main(["--smoke", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--model", "ernie"])
    assert isinstance(res["model"], ErnieForSequenceClassification)
    assert res["model"].classifier.out_features == example.NUM_CLASSES
    with pytest.raises(NotImplementedError):
        example.main(["--smoke", "--device", "cpu", "--dp", "2"])


def test_reference_ernie_config_has_no_num_labels():
    """The reference example's ``--model ernie`` passes ``num_labels`` to
    ``ErnieConfig``, which has none (ROADMAP Queue 3); the class count is
    the model's ``num_classes``, as the port's example passes it."""
    from paddle_tpu.models import ErnieConfig as RefErnieConfig
    with pytest.raises(TypeError):
        RefErnieConfig.tiny(num_labels=4)
    with pytest.raises(TypeError):
        ErnieConfig.tiny(num_labels=4)


def test_ernie_encoder_keeps_the_reference_eps():
    """ERNIE's encoder LayerNorms use the default eps 1e-5; only the
    embedding norm takes the config's 1e-12, as in the reference."""
    _, port = _pair("ernie")
    assert port.ernie.embeddings.layer_norm._epsilon == 1e-12
    assert {m._epsilon for layer in port.ernie.encoder.layers
            for m in (layer.norm1, layer.norm2)} == {1e-5}
