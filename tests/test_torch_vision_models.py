"""The vision model zoo of the port (``vision/models/``: LeNet, AlexNet,
VGG, MobileNet v1 / v2 / v3, SqueezeNet, ShuffleNet v2, DenseNet,
GoogLeNet, Inception v3) against the reference's on the CPU, and the
activations and ``ops.manipulation`` functions they call.

Each family's eval forward at batch 2 runs in both packages on the same
weights: the port's draws, with every BatchNorm's scale, shift and
running stats redrawn from numpy (so that each takes part), loaded into
the reference and then from the reference's ``state_dict`` into the port
(``convert.load_reference_state_dict``, which checks every name and
shape). The reference runs its forward as one jitted program
(``jit.bridge.functionalize``) and is built with a constant global
initializer: its own draws are overwritten anyway, and drawing them
op by op takes longer than this file may. The widths are cut where a
family takes a ``scale`` and the inputs are small; AlexNet and VGG run
without their classifiers (products of 9216 and 25088 by 4096: the other
families' heads are the same ``Linear`` layers, and dropout is the
identity in eval). GoogLeNet (224, its auxiliary heads' input) and
Inception v3 run in ``tests/test_torch_vision_inception.py``.
Eval outputs shrink through deep stacks of BatchNorm at unit running
variance, so the f32 outputs are held to 2e-5 of the largest output.

Both packages' ``TrainStep``s of ``mobilenet_v3_small`` and
``shufflenet_v2_x0_25`` are held to each other for two steps, in f64,
in ``tests/test_torch_vision_train.py``.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.framework.random import default_generator
from paddle_tpu.jit.bridge import functionalize
from paddle_tpu.nn import initializer as RI
from paddle_tpu.ops import manipulation as RM

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.ops import manipulation as PM

TOL = dict(atol=1e-6, rtol=1e-6)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def build_reference(ctor, **kw):
    """The reference's model from ``ctor``, its parameters drawn as
    constants (they are overwritten)."""
    RI.set_global_initializer(RI.Constant(0.0), RI.Constant(0.0))
    try:
        return ctor(**kw)
    finally:
        RI.set_global_initializer(None, None)


def shared_weights(port, ref, seed=0, redraw_bn=True):
    """The port's weights (BatchNorms redrawn unless ``redraw_bn`` is
    False), set in the reference and loaded back into the port from the
    reference's state dict."""
    rng = np.random.RandomState(seed)
    state = export_reference_state_dict(port)
    bns = {n for n, m in port.named_modules()
           if redraw_bn and isinstance(m, pt.nn.BatchNorm2D)}
    for k in state:
        owner, _, leaf = k.rpartition(".")
        if owner in bns:
            shape = state[k].shape
            state[k] = {"weight": rng.uniform(0.5, 1.5, shape),
                        "bias": rng.normal(0, 0.1, shape),
                        "_mean": rng.normal(0, 0.1, shape),
                        "_variance": rng.uniform(0.5, 1.5, shape)}[leaf] \
                .astype(np.float32)
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_reference_state_dict(port, {k: np.asarray(v.numpy()) for k, v in
                                     ref.state_dict().items()})


def reference_forward(ref, x):
    """``ref``'s eval forward as one jitted program: a tuple of outputs."""
    ref.eval()
    # the global key made here, not inside the trace (pure_fn returns it)
    default_generator()._key
    fn, params, buffers, _, _ = functionalize(ref)

    def run(p, b, a):
        out = fn(p, b, None, a)[0]
        return tuple(o._value for o in (out if isinstance(out, tuple)
                                        else (out,)))
    return [np.asarray(o) for o in jax.jit(run)(params, buffers, x)]


# (constructor, kwargs, input shape)
FAMILIES = {
    "lenet": ("LeNet", {}, (1, 28, 28)),
    "alexnet": ("alexnet", dict(num_classes=0), (3, 64, 64)),
    "vgg11_bn": ("vgg11", dict(batch_norm=True, num_classes=0), (3, 32, 32)),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25, num_classes=10),
                     (3, 32, 32)),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.25, num_classes=10),
                     (3, 32, 32)),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           dict(scale=0.5, num_classes=10), (3, 32, 32)),
    "mobilenet_v3_large": ("mobilenet_v3_large",
                           dict(scale=0.35, num_classes=10), (3, 32, 32)),
    "squeezenet1_0": ("squeezenet1_0", dict(num_classes=10), (3, 47, 47)),
    "squeezenet1_1": ("squeezenet1_1", dict(num_classes=10), (3, 47, 47)),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", dict(num_classes=10),
                            (3, 32, 32)),
    "shufflenet_v2_swish": ("shufflenet_v2_swish", dict(num_classes=10),
                            (3, 32, 32)),
    "densenet121": ("densenet121", dict(num_classes=10), (3, 32, 32)),
    "googlenet": ("googlenet", dict(num_classes=10), (3, 224, 224)),
    "inception_v3": ("inception_v3", dict(num_classes=10), (3, 75, 75)),
}


# run in tests/test_torch_vision_inception.py, which has the time for them
INCEPTION = ("googlenet", "inception_v3")


def check_family_forward(family):
    name, kw, shape = FAMILIES[family]
    pt.seed(0)
    port = getattr(pt.vision.models, name)(device="cpu", **kw)
    ref = build_reference(getattr(paddle.vision.models, name), **kw)
    assert list(export_reference_state_dict(port)) == list(ref.state_dict())
    shared_weights(port, ref)
    x = np.random.RandomState(1).rand(2, *shape).astype(np.float32)
    want = reference_forward(ref, x)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    got = [_np(g) for g in (got if isinstance(got, tuple) else (got,))]
    assert len(got) == len(want) == (3 if name == "googlenet" else 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g - w).max() <= 2e-5 * scale, family


@pytest.mark.parametrize("family", [f for f in FAMILIES
                                    if f not in INCEPTION])
def test_family_forward_from_the_references_weights(family):
    check_family_forward(family)


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "mobilenet_v1",
                                  "mobilenet_v3_large", "squeezenet1_0",
                                  "googlenet", "inception_v3",
                                  "shufflenet_v2_x1_0", "densenet161"])
def test_constructors_refuse_pretrained_and_build_on_the_card(name):
    with pytest.raises(RuntimeError, match="pretrained"):
        getattr(pt.vision.models, name)(pretrained=True, device="cpu")
    if not torch.cuda.is_available() and name == "mobilenet_v1":
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(pt.vision.models, name)(scale=0.25)


def test_every_reference_constructor_is_exported():
    import paddle_tpu.vision.models as RM_
    names = {n for n in dir(RM_) if not n.startswith("_") and
             callable(getattr(RM_, n)) and
             getattr(RM_, n).__module__.startswith("paddle_tpu.vision")}
    assert names <= set(pt.vision.models.__all__)
    for n in ("LeNet", "VGG", "vgg16", "MobileNetV2", "mobilenet_v2",
              "transforms", "set_image_backend", "get_image_backend",
              "image_load", "datasets", "models"):
        assert hasattr(pt.vision, n) and hasattr(paddle.vision, n), n


# ----------------------------------------------------------- activations --

def test_activations_equal_the_references():
    x = np.linspace(-8, 8, 161).astype(np.float32).reshape(7, 23)
    t, r = torch.from_numpy(x), paddle.to_tensor(x)
    for fn, args in (("relu6", ()), ("hardswish", ()), ("hardsigmoid", ()),
                     ("hardsigmoid", (0.2, 0.3)), ("swish", ()),
                     ("silu", ())):
        np.testing.assert_allclose(_np(getattr(PF, fn)(t, *args)),
                                   _np(getattr(RF, fn)(r, *args)), **TOL)
    # the reference's slope is 0.1666667, not torch's 1/6
    x64 = torch.tensor(-2.9, dtype=torch.float64)
    assert float(PF.hardsigmoid(x64)) == 0.1666667 * -2.9 + 0.5
    for layer, args in (("ReLU6", ()), ("Hardswish", ()),
                        ("Hardsigmoid", ()), ("Swish", ())):
        np.testing.assert_allclose(
            _np(getattr(pt.nn, layer)(*args)(t)),
            _np(getattr(paddle.nn, layer)(*args)(r)), **TOL)


# ----------------------------------------------------------- manipulation --

def test_manipulation_ops_equal_the_references():
    a = np.arange(2 * 6 * 3 * 2, dtype=np.float32).reshape(2, 6, 3, 2)
    t, r = torch.from_numpy(a), paddle.to_tensor(a)
    pairs = [
        (PM.reshape(t, [2, 3, -1]), RM.reshape(r, [2, 3, -1])),
        (PM.reshape(t, torch.tensor([4, 18])), RM.reshape(r, [4, 18])),
        (PM.transpose(t, [0, 2, 1, 3]), RM.transpose(r, [0, 2, 1, 3])),
        (PM.transpose(t), RM.transpose(r)),
        (PM.concat([t, t * 2], axis=1), RM.concat([r, r * 2], axis=1)),
        (PM.flatten(t, 1), RM.flatten(r, 1)),
        (PM.flatten(t, 1, 2), RM.flatten(r, 1, 2)),
        (PM.flatten(torch.tensor(3.0)), RM.flatten(paddle.to_tensor(3.0))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(_np(got), _np(want))
    for sections in (3, [1, -1, 2], [2, 2, 2]):
        got, want = PM.split(t, sections, 1), RM.split(r, sections, 1)
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
    # an int is the number of equal parts (torch's is a part's size)
    assert [p.shape[1] for p in PM.split(t, 2, axis=1)] == [3, 3]
    with pytest.raises(ValueError, match="divisible"):
        PM.split(t, 4, axis=1)
