"""The port's vision path against the JAX reference on the CPU: the ops
(``conv2d`` in every padding form, with groups, dilation and NHWC;
``batch_norm`` in training, eval and ``use_global_stats``, running stats
after 3 steps; the 2-D pools with ``ceil_mode`` and ``exclusive``; the
adaptive pools; ``softmax``; ``cross_entropy`` with every option, and
``nll_loss``), the layers (``Conv2D`` / ``BatchNorm2D`` draws and names,
``Sequential``), the ResNet family's names and shapes, and one
``TrainStep`` of ResNet-50 against the reference's.

Inputs are drawn from numpy with a seed. f32 tolerance: atol = rtol =
1e-5 unless a test says otherwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.jit import TrainStep

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _r(a):
    return paddle.to_tensor(a)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


# ------------------------------------------------------------------ conv --

CONV_CASES = [
    dict(padding=0),
    dict(padding=1),
    dict(padding=[1, 2]),
    dict(padding=[1, 0, 2, 1]),
    dict(padding=[[0, 1], [2, 1]]),
    dict(padding="SAME"),
    dict(padding="SAME", stride=2),
    dict(padding="VALID", stride=2),
    dict(padding="same", dilation=2),
    dict(padding=2, dilation=2, stride=[2, 1]),
    dict(padding=1, groups=2),
    dict(padding=1, groups=4, bias=False),
    dict(padding=1, data_format="NHWC"),
    dict(padding=[1, 0, 2, 1], stride=2, data_format="NHWC", groups=2),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[str(i) for i in range(len(CONV_CASES))])
def test_conv2d_matches_the_reference(case):
    case = dict(case)
    nhwc = case.get("data_format") == "NHWC"
    groups = case.get("groups", 1)
    use_bias = case.pop("bias", True)
    x = _rand(0, 2, 9, 11, 4) if nhwc else _rand(0, 2, 4, 9, 11)
    w = _rand(1, 8, 4 // groups, 3, 3)
    b = _rand(2, 8) if use_bias else None
    want = RF.conv2d(_r(x), _r(w), None if b is None else _r(b), **case)
    got = PF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b), **case)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_conv2d_layer_draw_and_names():
    """``Conv2D``'s weight is [out, in / groups, kh, kw] in both packages,
    Kaiming-uniform (bound sqrt(6 / ((1 + 5) fan_in))) with a
    U(+-1 / sqrt(fan_in)) bias; ``bias_attr=False`` leaves it out."""
    pt.seed(0)
    port = pt.nn.Conv2D(16, 32, 3, groups=2, device="cpu")
    ref = paddle.nn.Conv2D(16, 32, 3, groups=2)
    assert tuple(port.weight.shape) == tuple(ref.weight.shape) == (32, 8, 3,
                                                                   3)
    fan_in = 8 * 9
    bound = np.sqrt(6.0 / (6 * fan_in))
    for w in (_np(port.weight), _np(ref.weight)):
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    for b in (_np(port.bias), _np(ref.bias)):
        assert np.abs(b).max() <= 1 / np.sqrt(fan_in)
    nb = pt.nn.Conv2D(3, 4, 1, bias_attr=False, device="cpu")
    assert nb.bias is None and list(nb.state_dict()) == ["weight"]
    assert list(port.state_dict()) == list(ref.state_dict())


# ------------------------------------------------------------ batch norm --

@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm_training_updates_running_stats(data_format):
    """Three training forwards, then one in eval: every output and the
    running stats after each step, BatchNorm2D against the reference's
    (momentum 0.9: ``r = 0.9 r + 0.1 b``, the variance unbiased)."""
    ref = paddle.nn.BatchNorm2D(6, momentum=0.9, data_format=data_format)
    port = pt.nn.BatchNorm2D(6, momentum=0.9, data_format=data_format,
                             device="cpu")
    w, b = _rand(3, 6), _rand(4, 6)
    ref.set_state_dict({"weight": _r(w), "bias": _r(b)})
    port.set_state_dict({"weight": w, "bias": b})
    shape = (4, 5, 3, 6) if data_format == "NHWC" else (4, 6, 5, 3)
    for step in range(3):
        x = _rand(10 + step, *shape) * 2 + 1
        np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                                   _np(ref(_r(x))), **TOL)
        np.testing.assert_allclose(_np(port._mean), _np(ref._mean), **TOL)
        np.testing.assert_allclose(_np(port._variance), _np(ref._variance),
                                   **TOL)
    ref.eval()
    port.eval()
    x = _rand(20, *shape)
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                               _np(ref(_r(x))), **TOL)
    assert list(port.state_dict()) == ["weight", "bias", "_mean",
                                       "_variance"]


def test_batch_norm_functional_use_global_stats_overrides_training():
    """The batch's stats are used (and the running ones updated) exactly
    when ``training and not use_global_stats``: ``use_global_stats=True``
    normalises by the running stats even in training and leaves them
    alone."""
    x = _rand(0, 3, 4, 2, 2)
    mean, var = np.abs(_rand(1, 4)), np.abs(_rand(2, 4)) + 0.5
    for training, ugs in ((True, True), (False, False), (True, False),
                          (False, None)):
        rm, rv = _r(mean.copy()), _r(var.copy())
        pm, pv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
        want = RF.batch_norm(_r(x), rm, rv, training=training,
                             use_global_stats=ugs)
        got = PF.batch_norm(torch.from_numpy(x), pm, pv, training=training,
                            use_global_stats=ugs)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(_np(pm), _np(rm), **TOL)
        np.testing.assert_allclose(_np(pv), _np(rv), **TOL)
        moved = training and not ugs
        assert np.array_equal(_np(pm), mean) != moved


def test_batch_norm_1d_and_legacy_batch_norm():
    x = _rand(0, 8, 5)
    ref, port = paddle.nn.BatchNorm1D(5), pt.nn.BatchNorm1D(5, device="cpu")
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                               _np(ref(_r(x))), **TOL)
    np.testing.assert_allclose(_np(port._variance), _np(ref._variance),
                               **TOL)
    x = _rand(1, 2, 3, 4, 4)
    ref = paddle.nn.BatchNorm(3, act="relu")
    port = pt.nn.BatchNorm(3, act="relu", device="cpu")
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                               _np(ref(_r(x))), **TOL)


# --------------------------------------------------------------- pooling --

POOL_CASES = [
    ("max", dict(kernel_size=3, stride=2, padding=1), (2, 3, 9, 9)),
    ("max", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True),
     (2, 3, 11, 11)),
    ("max", dict(kernel_size=3, stride=2, ceil_mode=True), (1, 2, 8, 10)),
    ("max", dict(kernel_size=[3, 2], stride=[2, 1], padding=[1, 0],
                 data_format="NHWC"), (2, 7, 6, 3)),
    ("avg", dict(kernel_size=3, stride=2, padding=1), (2, 3, 9, 9)),
    ("avg", dict(kernel_size=3, stride=2, padding=1, exclusive=False),
     (2, 3, 9, 9)),
    ("avg", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True,
                 exclusive=False), (2, 3, 11, 11)),
    ("avg", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True),
     (2, 3, 11, 11)),
    ("avg", dict(kernel_size=3, stride=1, padding=1, data_format="NHWC"),
     (2, 5, 5, 3)),
]


@pytest.mark.parametrize("op,kw,shape", POOL_CASES,
                         ids=[str(i) for i in range(len(POOL_CASES))])
def test_pool2d_matches_the_reference(op, kw, shape):
    x = _rand(0, *shape)
    want = getattr(RF, f"{op}_pool2d")(_r(x), **kw)
    got = getattr(PF, f"{op}_pool2d")(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_max_pool2d_return_mask():
    x = _rand(0, 2, 3, 7, 7)
    want_out, want_idx = RF.max_pool2d(_r(x), 3, 2, 1, return_mask=True)
    got_out, got_idx = PF.max_pool2d(torch.from_numpy(x), 3, 2, 1,
                                     return_mask=True)
    np.testing.assert_allclose(_np(got_out), _np(want_out), **TOL)
    np.testing.assert_array_equal(_np(got_idx), _np(want_idx))


@pytest.mark.parametrize("op", ["avg", "max"])
@pytest.mark.parametrize("size,out", [((7, 7), (1, 1)), ((6, 6), (3, 3)),
                                      ((7, 5), (5, 3)), ((9, 7), (2, 3))])
def test_adaptive_pool2d_matches_the_reference(op, size, out):
    x = _rand(0, 2, 3, *size)
    want = getattr(RF, f"adaptive_{op}_pool2d")(_r(x), out)
    got = getattr(PF, f"adaptive_{op}_pool2d")(torch.from_numpy(x), out)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_adaptive_avg_pool2d_nhwc_and_the_pool_layers():
    x = _rand(0, 2, 7, 5, 3)
    np.testing.assert_allclose(
        _np(PF.adaptive_avg_pool2d(torch.from_numpy(x), 2, "NHWC")),
        _np(RF.adaptive_avg_pool2d(_r(x), 2, "NHWC")), **TOL)
    x = _rand(1, 2, 3, 9, 9)
    for name, args in (("MaxPool2D", (3, 2, 1)),
                       ("AvgPool2D", (3, 2, 1)),
                       ("AdaptiveAvgPool2D", ((1, 1),)),
                       ("AdaptiveMaxPool2D", (2,))):
        want = getattr(paddle.nn, name)(*args)(_r(x))
        got = getattr(pt.nn, name)(*args)(torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    got = pt.nn.AvgPool2D(2, ceil_mode=True, exclusive=False)(
        torch.from_numpy(x))
    want = paddle.nn.AvgPool2D(2, ceil_mode=True, exclusive=False)(_r(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# -------------------------------------------------- activations and losses --

def test_relu_softmax_flatten_and_their_layers():
    x = _rand(0, 2, 3, 4, 5)
    for fn in ("relu", "softmax", "log_softmax"):
        np.testing.assert_allclose(_np(getattr(PF, fn)(torch.from_numpy(x))),
                                   _np(getattr(RF, fn)(_r(x))), **TOL)
    np.testing.assert_allclose(
        _np(PF.softmax(torch.from_numpy(x), axis=1, dtype="float64")),
        _np(RF.softmax(_r(x), axis=1, dtype="float64")), **TOL)
    np.testing.assert_allclose(_np(pt.nn.Softmax(1)(torch.from_numpy(x))),
                               _np(paddle.nn.Softmax(1)(_r(x))), **TOL)
    np.testing.assert_allclose(_np(pt.nn.ReLU()(torch.from_numpy(x))),
                               _np(paddle.nn.ReLU()(_r(x))), **TOL)
    got = pt.nn.Flatten()(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(paddle.nn.Flatten()(_r(x)).shape)
    assert tuple(PF.flatten(torch.from_numpy(x), 1, 2).shape) == (2, 12, 5)
    y = torch.from_numpy(x.copy())
    assert PF.relu_(y) is y and (y >= 0).all()
    assert pt.nn.Identity(3, k=1)(y) is y


CE_CASES = [
    dict(),
    dict(reduction="sum"),
    dict(reduction="none", ignore_index=2),
    dict(ignore_index=2),
    dict(label_smoothing=0.1),
    dict(label_smoothing=0.2, reduction="none"),
    dict(weight=True),
    dict(weight=True, ignore_index=1),
    dict(weight=True, label_smoothing=0.1),
    dict(weight=True, label_smoothing=0.1, reduction="sum"),
    dict(soft_label=True),
    dict(soft_label=True, label_smoothing=0.1),
    dict(soft_label=True, weight=True, reduction="none"),
    dict(use_softmax=False),
    dict(use_softmax=False, label_smoothing=0.1, weight=True),
    dict(axis=1),
    dict(axis=1, label_smoothing=0.1, weight=True),
    dict(label_dims=True),
]


@pytest.mark.parametrize("case", CE_CASES,
                         ids=[str(i) for i in range(len(CE_CASES))])
def test_cross_entropy_matches_the_reference(case):
    """Every option of ``cross_entropy`` (``weight``, ``soft_label``,
    ``label_smoothing``, ``use_softmax=False``, ``axis``, ``ignore_index``,
    each reduction) on [6, 5] logits ([6, 5, 3] for axis 1)."""
    case = dict(case)
    rng = np.random.RandomState(0)
    axis = case.get("axis", -1)
    shape = (6, 5, 3) if axis == 1 else (6, 5)
    logits = rng.randn(*shape).astype(np.float32)
    if not case.get("use_softmax", True):
        e = np.exp(logits)
        logits = (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)
    weight = None
    if case.pop("weight", False):
        weight = rng.rand(5).astype(np.float32) + 0.5
    if case.get("soft_label"):
        lab = rng.rand(*shape).astype(np.float32)
        label = lab / lab.sum(axis=axis, keepdims=True)
    else:
        lshape = (6, 3) if axis == 1 else (6,)
        label = rng.randint(0, 5, lshape).astype(np.int64)
        label[0] = 2
        if case.pop("label_dims", False):
            label = label[:, None]
    case.pop("label_dims", None)
    want = RF.cross_entropy(_r(logits), _r(label),
                            weight=None if weight is None else _r(weight),
                            **case)
    got = PF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                           weight=None if weight is None
                           else torch.from_numpy(weight), **case)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    layer = pt.nn.CrossEntropyLoss(
        None if weight is None else torch.from_numpy(weight), **case)
    np.testing.assert_allclose(_np(layer(torch.from_numpy(logits),
                                         torch.from_numpy(label))),
                               _np(want), **TOL)


def test_cross_entropy_gradient_with_label_smoothing_and_weight():
    rng = np.random.RandomState(1)
    logits = rng.randn(8, 10).astype(np.float32)
    label = rng.randint(0, 10, (8,)).astype(np.int64)
    weight = rng.rand(10).astype(np.float32) + 0.5
    x = torch.from_numpy(logits).requires_grad_()
    PF.cross_entropy(x, torch.from_numpy(label),
                     torch.from_numpy(weight), label_smoothing=0.1).backward()
    import jax
    import jax.numpy as jnp

    def loss(v):
        return RF.cross_entropy(paddle.Tensor(v), _r(label), _r(weight),
                                label_smoothing=0.1)._value
    want = jax.grad(loss)(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


def test_cross_entropy_out_of_range_label_is_nan_and_all_ignored_is_zero():
    x = torch.randn(3, 4)
    assert torch.isnan(PF.cross_entropy(x, torch.tensor([0, 4, 1]),
                                        label_smoothing=0.1))
    assert float(PF.cross_entropy(x, torch.full((3,), -100))) == 0.0
    with pytest.raises(TypeError):
        PF.cross_entropy(x, torch.tensor([0.0, 1.0, 2.0]))


@pytest.mark.parametrize("kw", [dict(), dict(reduction="sum"),
                                dict(ignore_index=1), dict(weight=True),
                                dict(weight=True, ignore_index=1,
                                     reduction="none")])
def test_nll_loss_softmax_with_ce_and_label_smooth(kw):
    kw = dict(kw)
    rng = np.random.RandomState(2)
    logp = np.log(rng.dirichlet(np.ones(5), 7)).astype(np.float32)
    label = rng.randint(0, 5, (7,)).astype(np.int64)
    label[0] = 1
    w = rng.rand(5).astype(np.float32) + 0.5 if kw.pop("weight", False) \
        else None
    want = RF.nll_loss(_r(logp), _r(label), None if w is None else _r(w),
                       **kw)
    wt = None if w is None else torch.from_numpy(w)
    got = PF.nll_loss(torch.from_numpy(logp), torch.from_numpy(label), wt,
                      **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    layer = pt.nn.NLLLoss(wt, **kw)
    np.testing.assert_allclose(_np(layer(torch.from_numpy(logp),
                                         torch.from_numpy(label))),
                               _np(want), **TOL)
    logits = rng.randn(7, 5).astype(np.float32)
    want_l, want_s = RF.softmax_with_cross_entropy(
        _r(logits), _r(label[:, None]), return_softmax=True)
    got_l, got_s = PF.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label[:, None]),
        return_softmax=True)
    np.testing.assert_allclose(_np(got_l), _np(want_l), **TOL)
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL)
    onehot = np.eye(5, dtype=np.float32)[label]
    np.testing.assert_allclose(
        _np(PF.label_smooth(torch.from_numpy(onehot), epsilon=0.2)),
        _np(RF.label_smooth(_r(onehot), epsilon=0.2)), **TOL)


# ----------------------------------------------------------------- amp --

def test_amp_o1_runs_convolutions_in_bf16_and_batch_norm_in_f32():
    """At O1 the convolution's inputs are cast to bf16 (white list) and
    BatchNorm's and softmax's to f32 (black list); the pools keep their
    input's dtype at O1 and take the amp dtype at O2, as the
    reference's named ops do."""
    x = torch.randn(2, 3, 8, 8)
    conv = pt.nn.Conv2D(3, 4, 3, padding=1, device="cpu")
    bn = pt.nn.BatchNorm2D(4, device="cpu")
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        y = conv(x)
        assert y.dtype == torch.bfloat16
        z = bn(y)
        assert z.dtype == torch.float32
        assert PF.max_pool2d(y, 2).dtype == torch.bfloat16
        assert PF.max_pool2d(z, 2).dtype == torch.float32
        assert PF.softmax(y).dtype == torch.float32
    with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
        assert PF.avg_pool2d(z, 2).dtype == torch.bfloat16
    assert bn._mean.dtype == torch.float32


# --------------------------------------------------------------- models --

def test_sequential_indexing_and_names():
    a, b = pt.nn.ReLU(), pt.nn.Flatten()
    seq = pt.nn.Sequential(a, b)
    assert len(seq) == 2 and seq[0] is a and seq[-1] is b
    assert list(seq[1:]) == [b] and list(seq) == [a, b]
    named = pt.nn.Sequential(("act", a), ("flat", b))
    assert named["flat"] is b
    assert [n for n, _ in named.named_children()] == ["act", "flat"]
    x = torch.randn(2, 3, 4)
    assert torch.equal(seq(x), torch.relu(x).reshape(2, 12))


@pytest.mark.parametrize("name,kw", [
    ("resnext50_32x4d", {}),
    ("resnet18", {"num_classes": 0, "with_pool": False})])
def test_resnet_state_dict_keys_and_shapes_equal_the_reference(name, kw):
    """The same names (BN buffers ``_mean`` / ``_variance`` included),
    order and shapes (ResNet-50's in the train-step test);
    ``pretrained=True`` raises."""
    ref = getattr(paddle.vision.models, name)(**kw)
    port = getattr(pt.vision.models, name)(device="cpu", **kw)
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in
           export_reference_state_dict(port).items()}
    assert list(got) == list(want) and got == want
    with pytest.raises(RuntimeError):
        getattr(pt.vision.models, name)(pretrained=True, device="cpu")


def test_resnet_builds_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.vision.resnet18()


def test_resnet18_eval_forward_matches_the_reference():
    paddle.seed(1)
    ref = paddle.vision.models.resnet18(num_classes=7)
    port = pt.vision.resnet18(num_classes=7, device="cpu")
    load_reference_state_dict(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    ref.eval()
    port.eval()
    np.testing.assert_allclose(_np(port(torch.from_numpy(x))),
                               _np(ref(_r(x))), **TOL)


def test_resnet50_train_step_matches_the_reference():
    """Two ``TrainStep``s of ResNet-50 (10 classes) at [4, 3, 64, 64]:
    Momentum(0.1, 0.9) with ``L2Decay(1e-4)`` on cross entropy with label
    smoothing 0.1, in both packages from the same weights, in f64.

    In f32 a freshly drawn ResNet-50's step is ill conditioned: rounding
    grows through the forward and more through the backward, so either
    package's f32 step lies up to ~0.2 of a weight's change from its own
    f64 step (``tools/resnet_step_conditioning.py``) and a second step
    more. In f64 the two packages agree over two steps far inside the
    limits held here: both losses to rtol 1e-10 and every weight and
    BatchNorm running stat to 1e-8 of the change the reference's steps
    made to it; a port without the decay or without the momentum lies
    orders of magnitude outside them. The step's
    ``cost_analysis`` FLOPs lie within [1, 1.15] of the reference's
    lowered count: the port counts each convolution's and product's
    forward, input gradient and weight gradient; XLA also counts
    elementwise work, but not the first convolution's input gradient,
    which the step never forms."""
    paddle.seed(0)
    ref = paddle.vision.models.resnet50(num_classes=10)
    init = {k: np.asarray(v.numpy(), np.float64)
            for k, v in ref.state_dict().items()}
    ref.to(dtype="float64")
    rng = np.random.RandomState(0)
    batches = [(rng.rand(4, 3, 64, 64), rng.randint(0, 10, (4,)))
               for _ in range(2)]
    from paddle_tpu.jit.bridge import TrainStep as RefStep
    ropt = paddle.optimizer.Momentum(
        0.1, 0.9, parameters=ref.parameters(),
        weight_decay=paddle.regularizer.L2Decay(1e-4))
    rce = paddle.nn.CrossEntropyLoss(label_smoothing=0.1)
    rstep = RefStep(ref, ropt, lambda o, t: rce(o, t))
    want_losses = [float(rstep(_r(x), _r(y))) for x, y in batches]
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    ref_flops = rstep.cost_analysis(*map(_r, batches[0]))["flops"]

    model = pt.vision.resnet50(num_classes=10, device="cpu")
    load_reference_state_dict(model, init)
    model.to(dtype=torch.float64)
    opt = pt.optimizer.Momentum(0.1, 0.9, parameters=model.parameters(),
                                weight_decay=pt.regularizer.L2Decay(1e-4))
    ce = pt.nn.CrossEntropyLoss(label_smoothing=0.1)
    step = TrainStep(model, opt, lambda o, t: ce(o, t))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in batches]
    got = export_reference_state_dict(model)
    assert list(got) == list(want)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-10)
    for k, w in want.items():
        assert got[k].dtype == np.float64, k
        change = np.abs(w - init[k]).max()
        assert np.abs(got[k] - w).max() <= 1e-8 * change, k
    flops = step.cost_analysis(*map(torch.from_numpy, batches[0]))["flops"]
    assert 1.0 <= flops / ref_flops <= 1.15, (flops, ref_flops)
