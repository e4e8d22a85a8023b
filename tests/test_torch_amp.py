"""The port's ``amp`` (``auto_cast``, ``decorate``, ``GradScaler`` in the
eager loop and in ``TrainStep``, ``debugging``) against the JAX
reference, on the CPU.

Model parity runs tiny Llama and BERT models with the reference's
weights under O1 and O2 (over a decorated model) in f16 and bf16: the
dtypes of each decoder layer's output, the logits and the loss must be
the reference's; the loss within ``LOSS_RTOL`` and every gradient within
``GRAD_TOL`` of its tensor's largest value (both sides round at the same
ops, but sums in 16-bit products are taken in another order).
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as ramp
from paddle_tpu import models as RM
from paddle_tpu.framework.flags import get_flags, set_flags

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import linear_weights, load_reference_state_dict
from paddle_tpu_torch.framework import flags as port_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertConfig, BertForSequenceClassification,
                                     LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW

# per amp dtype: the loss (relative: BERT's 3-class loss over 16-bit
# logits moves by an ulp of them, ~5e-4 in f16) and each gradient (of
# its tensor's largest |value|); bf16 keeps 8 bits where f16 keeps 11
LOSS_RTOL = {"float16": 1e-3, "bfloat16": 5e-3}
GRAD_TOL = {"float16": 5e-3, "bfloat16": 5e-2}
# the f16 MLP scenario's 25 losses: f16 outputs of both packages' AdamW
# steps over f32 master weights
MLP_LOSS_TOL = dict(atol=2e-3, rtol=4e-3)


def _name(dtype):
    return str(dtype).rsplit(".", 1)[-1]


# ------------------------------------------------------------- state --

NAMES = sorted(amp._WHITE_LIST | amp._BLACK_LIST
               | {"swiglu", "fused_rope", "embedding", "dropout", "add", ""})


@pytest.mark.parametrize("custom", [None, "custom"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_dtype_for_matches_reference(level, dtype, custom):
    kw = dict(custom_white_list=["swiglu", "softmax"],
              custom_black_list=["matmul", "fused_rope"]) if custom else {}
    for name in NAMES:
        with ramp.auto_cast(level=level, dtype=dtype, **kw):
            want = ramp.amp_dtype_for(name)
        with amp.auto_cast(level=level, dtype=dtype, **kw):
            got = amp.amp_dtype_for(name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert _name(got) == str(np.dtype(want)), name
    assert amp.amp_dtype_for("linear") is None      # off outside the block


def test_auto_cast_nesting_restores():
    seen = []
    for pkg in (ramp, amp):
        states = [(pkg.is_autocast_enabled(), pkg.get_autocast_dtype())]
        with pkg.auto_cast(dtype="float16"):
            states.append((pkg.is_autocast_enabled(),
                           pkg.get_autocast_dtype()))
            with pkg.auto_cast(enable=False, level="O2"):
                states.append((pkg.is_autocast_enabled(),
                               pkg.get_autocast_dtype()))
                with pkg.amp_guard(level="O2", dtype="bfloat16"):
                    states.append((pkg.is_autocast_enabled(),
                                   pkg.get_autocast_dtype(),
                                   pkg.amp_state().level))
                states.append(pkg.amp_state().level)
            states.append((pkg.is_autocast_enabled(),
                           pkg.get_autocast_dtype(),
                           pkg.amp_state().level))
        states.append((pkg.is_autocast_enabled(), pkg.get_autocast_dtype()))
        seen.append(states)
    assert seen[0] == seen[1]
    assert seen[1][0] == (False, "float32") and seen[1][-1] == seen[1][0]


def test_public_names_match_reference():
    """Every public name of the reference's ``amp`` but the operator-stats
    collection and the tensor checker (ROADMAP)."""
    skip = {"contextlib", "dtypes", "annotations"}
    want = {n for n in dir(ramp) if not n.startswith("_")} - skip
    missing = {n for n in want if not hasattr(amp, n)}
    assert not missing, missing
    left_out = {"enable_operator_stats_collection",
                "disable_operator_stats_collection",
                "collect_operator_stats", "enable_tensor_checker",
                "disable_tensor_checker"}
    want_dbg = {n for n in dir(ramp.debugging) if not n.startswith("_")}
    got_dbg = {n for n in dir(amp.debugging) if not n.startswith("_")}
    assert got_dbg == want_dbg - left_out


def test_decorate_o2_casts_params_and_buffers():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    opt = AdamW(parameters=model.parameters())
    assert amp.decorate(model, level="O1", dtype="float16") is model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = amp.decorate(model, opt, level="O2", dtype="float16")
    assert got == (model, opt)
    assert all(p.dtype == torch.float16 for p in model.parameters())
    assert model.llama.rope_cos.dtype == torch.float16
    # the optimizer keeps f32 masters for the now 16-bit parameters
    st = opt._state_of(model.lm_head.weight)
    assert st["master_weight"].dtype == torch.float32
    assert torch.equal(st["master_weight"], model.lm_head.weight.float())
    paddle.seed(0)
    ref = RM.LlamaForCausalLM(RM.LlamaConfig.tiny())
    ramp.decorate(ref, level="O2", dtype="float16")
    want = {n: str(p.dtype) for n, p in ref.named_parameters()}
    assert {n: _name(p.dtype) for n, p in model.named_parameters()} == want


# ------------------------------------------------------ model parity --

def _grads_close(ref, port, dtype):
    want = {n: np.asarray(p.grad.numpy(), np.float32)
            for n, p in ref.named_parameters()}
    lin = linear_weights(port)
    for n, p in port.named_parameters():
        if n.endswith("k_proj.bias"):
            # exactly 0 in exact arithmetic (the softmax ignores a constant
            # added to a query's scores): both sides give rounding noise
            continue
        g = p.grad.float().numpy()
        g = g.T if n in lin else g
        top = float(np.abs(want[n]).max())
        np.testing.assert_allclose(g, want[n], rtol=0,
                                   atol=GRAD_TOL[dtype] * top, err_msg=n)


def _hook_dtypes(ref_layers, port_layers):
    got, want = [], []
    for layer in ref_layers:
        layer.register_forward_post_hook(
            lambda m, i, o: want.append(str((o[0] if isinstance(o, tuple)
                                             else o).dtype)))
    for layer in port_layers:
        layer.register_forward_hook(
            lambda m, i, o: got.append(_name((o[0] if isinstance(o, tuple)
                                              else o).dtype)))
    return got, want


CASES = [("O1", "float16"), ("O2", "float16"), ("O1", "bfloat16"),
         ("O2", "bfloat16")]


@pytest.mark.parametrize("level,dtype", CASES)
def test_llama_amp_matches_reference(level, dtype):
    paddle.seed(0)
    ref = RM.LlamaForCausalLM(RM.LlamaConfig.tiny())
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state_dict(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
    if level == "O2":
        ramp.decorate(ref, level="O2", dtype=dtype)
        amp.decorate(port, level="O2", dtype=dtype)
    got, want = _hook_dtypes(ref.llama.layers, port.llama.layers)
    ids = np.random.RandomState(0).randint(0, 256, (2, 16)).astype(np.int64)
    with ramp.auto_cast(level=level, dtype=dtype):
        r_logits = ref(paddle.to_tensor(ids))
        r_loss = RM.LlamaPretrainingCriterion(ref.config)(
            r_logits, paddle.to_tensor(ids))
    r_loss.backward()
    with amp.auto_cast(level=level, dtype=dtype):
        logits = port(torch.from_numpy(ids))
        loss = LlamaPretrainingCriterion()(logits, torch.from_numpy(ids))
    loss.backward()
    # O1: the residual stream stays f32 (rms_norm is black-listed, f32 +
    # f16 promotes); O2 over a decorated model: 16-bit
    assert got == want == [dtype if level == "O2" else "float32"] * 2
    assert _name(logits.dtype) == str(r_logits.dtype) == dtype
    assert loss.dtype == torch.float32 and str(r_loss.dtype) == "float32"
    np.testing.assert_allclose(float(loss), float(r_loss.numpy()),
                               rtol=LOSS_RTOL[dtype])
    _grads_close(ref, port, dtype)


@pytest.mark.parametrize("level,dtype", CASES)
def test_bert_amp_matches_reference(level, dtype):
    """BERT tiny (dropout off: the two packages draw other masks) under
    amp, with a padding mask."""
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               num_labels=3)
    paddle.seed(0)
    ref = RM.BertForSequenceClassification(RM.BertConfig.tiny(**cfg))
    port = BertForSequenceClassification(BertConfig.tiny(**cfg), device="cpu")
    load_reference_state_dict(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
    if level == "O2":
        ramp.decorate(ref, level="O2", dtype=dtype)
        amp.decorate(port, level="O2", dtype=dtype)
    got, want = _hook_dtypes(ref.bert.encoder.layers,
                             port.bert.encoder.layers)
    rs = np.random.RandomState(1)
    ids = rs.randint(1, 1000, (2, 16)).astype(np.int64)
    mask = np.ones((2, 16), np.int64)
    mask[1, 11:] = 0
    labels = np.array([0, 2], np.int64)
    with ramp.auto_cast(level=level, dtype=dtype):
        r_logits = ref(paddle.to_tensor(ids),
                       attention_mask=paddle.to_tensor(mask))
        r_loss = paddle.nn.functional.cross_entropy(
            r_logits, paddle.to_tensor(labels))
    r_loss.backward()
    with amp.auto_cast(level=level, dtype=dtype):
        logits = port(torch.from_numpy(ids),
                      attention_mask=torch.from_numpy(mask))
        loss = PF.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert got == want and len(got) == 2
    assert _name(logits.dtype) == str(r_logits.dtype)
    assert _name(loss.dtype) == str(r_loss.dtype) == "float32"
    np.testing.assert_allclose(float(loss), float(r_loss.numpy()),
                               rtol=LOSS_RTOL[dtype])
    _grads_close(ref, port, dtype)


# ------------------------------------------------------- eager scaler --

def _param(values, dtype=torch.float32):
    return torch.nn.Parameter(torch.tensor(values, dtype=dtype))


def test_grad_scaler_roundtrip():
    """The reference's ``TestAmp.test_grad_scaler_roundtrip``."""
    w = _param([1.0])
    opt = SGD(0.1, parameters=[w])
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    scaler.scale((w * 2.0).sum()).backward()
    scaler.step(opt)
    np.testing.assert_allclose(w.detach().numpy(), [1.0 - 0.2], rtol=1e-5)
    assert scaler.get_loss_scaling() == 128.0


def test_grad_scaler_skips_on_inf():
    """The reference's ``TestAmp.test_grad_scaler_skips_on_inf``: the same
    skipped step and the same scale in both packages."""
    w = _param([1.0])
    opt = SGD(0.1, parameters=[w])
    scaler = amp.GradScaler(init_loss_scaling=4.0)
    scaler.scale((w * float("inf")).sum()).backward()
    scaler.step(opt)
    rw = paddle.Parameter(np.array([1.0], np.float32))
    rsc = ramp.GradScaler(init_loss_scaling=4.0)
    rsc.scale((rw * float("inf")).sum()).backward()
    rsc.step(paddle.optimizer.SGD(0.1, parameters=[rw]))
    np.testing.assert_allclose(w.detach().numpy(), [1.0])
    assert scaler.get_loss_scaling() == rsc.get_loss_scaling() == 2.0


def test_eager_unscale_single_pass_and_found_inf():
    """The reference's ``TestEagerUnscaleBatched``: every gradient
    divided by the scale, one flag for all."""
    ps = [_param(np.ones((4, 4)) * 3.0, torch.float16), _param([1.0, 2, 3])]
    opt = SGD(0.1, parameters=ps)
    sc = amp.GradScaler(init_loss_scaling=8.0)
    rng = np.random.RandomState(0)
    before = []
    for p in ps:
        g = rng.randn(*p.shape) * 8.0
        p.grad = torch.tensor(g, dtype=p.dtype)
        before.append(p.grad.clone())
    sc.unscale_(opt)
    assert sc._found_inf is False
    for p, b in zip(ps, before):
        assert torch.equal(p.grad, (b.float() / 8.0).to(p.dtype))
    ps[1].grad[0] = float("inf")
    sc._unscaled = False
    sc.unscale_(opt)
    assert sc._found_inf is True


def test_scaler_state_dict_roundtrip():
    sc = amp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=3)
    w = _param([1.0])
    opt = SGD(0.1, parameters=[w])
    for _ in range(2):
        sc.scale((w * 2.0).sum()).backward()
        sc.step(opt)
        opt.clear_grad()
    state = sc.state_dict()
    assert state["scale"] == 64.0 and state["incr_count"] == 2
    rsc = ramp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=3)
    rsc._good_steps = 2
    assert state == rsc.state_dict()
    other = amp.GradScaler()
    other.load_state_dict(state)
    assert other.get_loss_scaling() == 64.0 and other._good_steps == 2


def test_check_numerics():
    amp.debugging.check_numerics(torch.ones(3), "op", "x")
    amp.debugging.check_numerics(torch.arange(4), "op", "ints")
    bad = torch.tensor([1.0, float("nan"), float("inf"), -float("inf")])
    with pytest.raises(FloatingPointError) as got:
        amp.debugging.check_numerics(bad, "matmul", "out")
    with pytest.raises(FloatingPointError) as want:
        ramp.debugging.check_numerics(paddle.to_tensor(bad.numpy()),
                                      "matmul", "out")
    assert str(got.value) == str(want.value)

    @amp.debugging.check_layer_numerics
    def forward(x):
        return x * 2.0, x.sum()
    forward(torch.ones(2))
    with pytest.raises(FloatingPointError):
        forward(bad)
    assert amp.debugging.DebugMode.CHECK_ALL == \
        ramp.debugging.DebugMode.CHECK_ALL
    cfg = amp.debugging.TensorCheckerConfig(
        debug_mode=amp.debugging.DebugMode.CHECK_NAN_INF)
    assert cfg.enable and cfg.debug_mode == 1


# --------------------------------------------------- scaler in a step --

class _Gelu(torch.nn.Module):
    def forward(self, x):
        return PF.gelu(x)


def _mlp_pair(dtype):
    """The reference's ``TestCompiledGradScaler`` MLP (Linear 8-16, GELU,
    Linear 16-4) in both packages, the port's with the reference's
    weights, parameters of ``dtype``."""
    import paddle_tpu.nn as rnn
    paddle.seed(0)
    ref = rnn.Sequential(rnn.Linear(8, 16), rnn.GELU(), rnn.Linear(16, 4))
    port = torch.nn.Sequential(Linear(8, 16), _Gelu(), Linear(16, 4))
    load_reference_state_dict(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
    for p in ref.parameters():
        p._value = p._value.astype(dtype)
    port.to(getattr(torch, dtype))
    return ref, port


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Any tensor-to-host read (item, bool, float, int, tolist) raises:
    on the card each is a sync with the device."""
    def refuse(*a, **k):
        raise AssertionError("the step read a tensor on the host")
    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        yield


def test_train_step_scaler_matches_reference_f16(monkeypatch):
    """The reference's ``TestCompiledGradScaler`` scenario: the f16 MLP,
    AdamW lr 1e-2, GradScaler(2^32): the first steps overflow and are
    skipped while the scale halves; the scale after every step equals the
    reference's, the losses are within f16 tolerance, and after the first
    step (which builds the fused plan) the port's step reads nothing back
    to the host: found-inf stays on the device."""
    from paddle_tpu.jit import TrainStep as RefTrainStep
    ref, port = _mlp_pair("float16")
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8).astype(np.float16)
    y = rs.randn(16, 4).astype(np.float16)

    def mse(o, t):
        return ((o - t) ** 2).mean()
    kw = dict(init_loss_scaling=2.0 ** 32, decr_every_n_nan_or_inf=1,
              incr_every_n_steps=1000)
    rsc, sc = ramp.GradScaler(**kw), amp.GradScaler(**kw)
    rstep = RefTrainStep(ref, paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=ref.parameters()), mse, scaler=rsc)
    step = TrainStep(port, AdamW(learning_rate=1e-2,
                                 parameters=port.parameters()), mse,
                     scaler=sc)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    w0 = port[0].weight.detach().clone()
    want, got = [], []
    for i in range(25):
        want.append((float(rstep(paddle.to_tensor(x), paddle.to_tensor(y))),
                     rsc.get_loss_scaling()))
        if i == 0:
            loss = step(xt, yt)
        else:
            with _no_host_reads(monkeypatch):
                loss = step(xt, yt)
        got.append((float(loss), sc.get_loss_scaling()))
    assert [s for _, s in got] == [s for _, s in want]
    assert got[16][1] == 2.0 ** 15 and got[0][1] == 2.0 ** 31
    np.testing.assert_allclose([v for v, _ in got], [v for v, _ in want],
                               **MLP_LOSS_TOL)
    assert got[-1][0] < got[0][0]
    assert not torch.equal(port[0].weight.detach(), w0)


def test_train_step_disabled_scaler_passes_through():
    ref, port = _mlp_pair("float32")
    step = TrainStep(port, SGD(0.1, parameters=port.parameters()),
                     lambda o, t: ((o - t) ** 2).mean(),
                     scaler=amp.GradScaler(enable=False))
    assert step._scaler is None
    x = torch.ones(2, 8)
    assert torch.isfinite(step(x, torch.zeros(2, 4)))


@pytest.mark.parametrize("poison", ["nan_grads", "nan_loss_only"])
def test_scaler_and_anomaly_guard_share_the_predicate(poison):
    """FLAGS_anomaly_guard on, scaler on, step 3 of 5 poisoned by a NaN
    batch input in both packages (the reference's step is traced once, so
    the poison is data): NaN gradients (found-inf and a NaN loss) or a NaN
    loss over finite gradients (the guard alone). The step changes no
    weight or optimizer state, the scale follows found-inf only, and the
    scales, losses and weights equal the reference's."""
    from paddle_tpu.jit import TrainStep as RefTrainStep
    old = get_flags(["anomaly_guard"])
    set_flags({"anomaly_guard": True})
    port_flags.set_flags({"anomaly_guard": True})
    try:
        ref, port = _mlp_pair("float32")
        rs = np.random.RandomState(3)
        x = rs.randn(16, 8).astype(np.float32)
        y = rs.randn(16, 4).astype(np.float32)

        def loss_fn(o, t, nan):
            loss = ((o - t) ** 2).mean()
            if poison == "nan_grads":
                return loss * (nan + 1.0)
            return loss + nan               # no gradient flows into nan
        kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
        rsc, sc = ramp.GradScaler(**kw), amp.GradScaler(**kw)
        rstep = RefTrainStep(ref, paddle.optimizer.Adam(
            learning_rate=1e-2, parameters=ref.parameters()), loss_fn,
            scaler=rsc)
        opt = Adam(learning_rate=1e-2, parameters=port.parameters())
        step = TrainStep(port, opt, loss_fn, scaler=sc)
        for i in range(5):
            nan = np.float32(np.nan if i == 2 else 0.0)
            if i == 2:
                before = {n: p.detach().clone()
                          for n, p in port.named_parameters()}
                st = {n: {k: v.clone() for k, v in opt._state_of(p).items()}
                      for n, p in port.named_parameters()}
            rl = float(rstep(paddle.to_tensor(x), paddle.to_tensor(y),
                             paddle.to_tensor(nan)))
            pl = float(step(torch.from_numpy(x), torch.from_numpy(y),
                            torch.tensor(nan)))
            assert sc.get_loss_scaling() == rsc.get_loss_scaling(), i
            assert sc._good_steps == rsc._good_steps, i
            if i == 2:
                assert np.isnan(pl) and np.isnan(rl)
                for n, p in port.named_parameters():
                    assert torch.equal(p.detach(), before[n]), n
                    for k, v in opt._state_of(p).items():
                        assert torch.equal(v, st[n][k]), (n, k)
            else:
                np.testing.assert_allclose(pl, rl, rtol=1e-5)
        want = {n: np.asarray(p.numpy()) for n, p in ref.named_parameters()}
        lin = linear_weights(port)
        for n, p in port.named_parameters():
            w = p.detach().numpy()
            np.testing.assert_allclose(w.T if n in lin else w, want[n],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        # x2 every 2 good steps, /2 at a found-inf step
        assert sc.get_loss_scaling() == (
            2.0 ** 11 if poison == "nan_grads" else 2.0 ** 12)
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})
        port_flags.set_flags({"anomaly_guard": True})
