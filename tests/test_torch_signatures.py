"""The port's constructors and functions bind their arguments as the
reference's do, and do what the reference does with them.

``test_positional_order_equals_the_reference`` compares, for every
callable below, the port's parameters with the reference's
``inspect.signature``: the same names in the same positional order with
the same defaults, so a positional call binds each argument to the same
parameter in both packages. The port may add keyword-only ``device`` /
``dtype`` after them, and may leave out a documented tail of the
reference's parameters (``TrainingArguments``' parallel degrees). The
other cases run the calls that used to bind another way or raise
(``Embedding(10, 4, None, False)``, ``Linear(2, 3, bias_attr=False)``,
``TrainStep(m, o, f, 1, False)``, ...) in both packages, and hold the
port's initializers to the reference's in distribution or value. f32
tolerance: atol = rtol = 1e-5.
"""
import copy
import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
import paddle_tpu_torch.optimizer  # noqa: F401  (pt.optimizer)
import paddle_tpu_torch.regularizer  # noqa: F401  (pt.regularizer)
from paddle_tpu_torch.nn import initializer as I

TOL = dict(atol=1e-5, rtol=1e-5)

# (module under both packages, name, reference parameters the port leaves
# out: a tail only, so no position moves)
CALLABLES = [
    ("nn.layers_common", "Linear", ()),
    ("nn.layers_common", "LayerNorm", ()),
    ("nn.layers_common", "Embedding", ()),
    ("nn.layers_common", "LayerList", ()),
    ("nn.layers_common", "Dropout", ()),
    ("nn.transformer", "MultiHeadAttention", ()),
    ("nn.transformer", "TransformerEncoderLayer", ()),
    ("nn.transformer", "TransformerEncoder", ()),
    ("jit.bridge", "TrainStep", ()),
    *[("jit.bridge", f"TrainStep.{n}", ()) for n in (
        "cost_analysis", "memory_analysis")],
    ("hapi.flops", "flops", ()),
    ("nn.functional", "cross_entropy", ()),
    ("nn", "CrossEntropyLoss", ()),
    ("optimizer", "SGD", ()),
    ("optimizer", "Momentum", ()),
    ("optimizer", "Adam", ()),
    ("optimizer", "AdamW", ()),
    ("nn.clip", "ClipGradByGlobalNorm", ()),
    ("nn.clip", "ClipGradByNorm", ()),
    ("nn.clip", "ClipGradByValue", ()),
    ("optimizer.lr", "LRScheduler", ()),
    ("optimizer.lr", "CosineAnnealingDecay", ()),
    ("optimizer.lr", "PolynomialDecay", ()),
    ("optimizer.lr", "LinearWarmup", ()),
    ("trainer", "TrainingArguments", ("dp_degree", "mp_degree",
                                      "pp_degree", "sharding_stage",
                                      "sep_degree")),
    ("incubate.nn.functional", "fused_layer_norm", ()),
    ("inference", "ContinuousBatchingPredictor", ()),
    *[("nn.initializer", n, ()) for n in (
        "Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
        "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign", "Dirac",
        "Orthogonal", "Bilinear", "ParamAttr", "calculate_gain",
        "set_global_initializer", "constant", "normal", "uniform")],
    ("nn.layer_base", "Layer", ()),
    # Layer's methods ("train" takes torch's positional ``mode``, which
    # torch's own containers pass: test_torch_layer.py pins it)
    *[("nn.layer_base", f"Layer.{n}", ()) for n in (
        "full_name", "add_parameter", "add_sublayer", "register_buffer",
        "create_parameter", "parameters", "named_buffers", "buffers",
        "named_sublayers", "sublayers", "children", "named_children",
        "apply", "eval", "register_forward_pre_hook",
        "register_forward_post_hook", "state_dict", "set_state_dict",
        "load_dict", "to", "astype", "float", "bfloat16", "float16",
        "clear_gradients")],
    ("nn.layer_base", "Layer.named_parameters", ("_seen",)),
    # the new top-level callables ("": the package itself)
    *[("framework.dtype", n, ()) for n in (
        "set_default_dtype", "get_default_dtype", "finfo", "iinfo")],
    *[("framework.place", n, ()) for n in (
        "set_device", "get_device", "CPUPlace", "CUDAPlace")],
    *[("framework.random", n, ()) for n in (
        "seed", "get_rng_state", "set_rng_state")],
    *[("framework_io", n, ()) for n in ("save", "load")],
    ("tensor", "to_tensor", ()),
    *[("autograd", n, ()) for n in (
        "no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled")],
    *[("", n, ()) for n in (
        "create_parameter", "in_dynamic_mode", "device_count", "seed",
        "to_tensor", "save", "load", "set_device", "get_device",
        "no_grad", "flops", "Model", "summary")],
    # the ResNet path: layers, ops, models, data, metrics, schedules, hapi
    *[("nn.layers_common", n, ()) for n in (
        "Sequential", "_ConvNd", "Conv2D", "_BatchNormBase", "BatchNorm1D",
        "BatchNorm2D", "BatchNorm", "ReLU", "Softmax", "MaxPool2D",
        "AvgPool2D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "Flatten",
        "Identity")],
    ("nn", "NLLLoss", ()),
    *[("nn.functional", n, ()) for n in (
        "relu", "relu_", "softmax", "log_softmax", "conv2d", "batch_norm",
        "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
        "adaptive_max_pool2d", "softmax_with_cross_entropy", "nll_loss",
        "label_smooth")],
    *[("vision.models.resnet", n, ()) for n in (
        "BasicBlock", "BottleneckBlock", "ResNet", "_resnet", "resnet18",
        "resnet34", "resnet50", "resnet101", "resnet152", "wide_resnet50_2",
        "wide_resnet101_2", "resnext50_32x4d", "resnext101_32x4d",
        "resnext101_64x4d", "resnext152_32x4d")],
    ("vision.datasets", "FakeData", ()),
    *[("io", n, ()) for n in (
        "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
        "ChainDataset", "ConcatDataset", "Subset", "random_split", "Sampler",
        "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
        "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
        "default_collate_fn", "default_convert_fn", "DataLoader")],
    *[("metric", n, ()) for n in (
        "Metric", "Accuracy", "Accuracy.compute", "Accuracy.update",
        "Precision", "Recall", "Auc", "accuracy")],
    *[("optimizer.lr", n, ()) for n in (
        "NoamDecay", "PiecewiseDecay", "NaturalExpDecay", "InverseTimeDecay",
        "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
        "MultiplicativeDecay", "CosineAnnealingWarmRestarts", "OneCycleLR",
        "CyclicLR", "ReduceOnPlateau", "ReduceOnPlateau.step", "LinearLR")],
    ("hapi.model", "Model", ()),
    *[("hapi.model", f"Model.{n}", ()) for n in (
        "prepare", "train_batch", "eval_batch", "predict_batch", "fit",
        "evaluate", "predict", "save", "load", "parameters", "summary")],
    ("hapi.model", "summary", ()),
    *[("hapi.callbacks", n, ()) for n in (
        "Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
        "LRScheduler", "VisualDL", "ReduceLROnPlateau", "config_callbacks")],
    # the vision input pipeline and model zoo: workers, ring, transforms,
    # datasets, models, activations, manipulation ops
    *[("io", n, ()) for n in ("get_worker_info", "multiprocess_reader")],
    *[("io._worker", n, ()) for n in (
        "WorkerInfo", "get_worker_info", "numpy_collate", "worker_loop")],
    ("_native", "ShmChannel", ()),
    *[("_native", f"ShmChannel.{n}", ()) for n in (
        "push", "pop", "push_obj", "pop_obj", "close_write", "close")],
    *[("vision.transforms", n, ()) for n in (
        "BaseTransform", "BrightnessTransform", "CenterCrop", "ColorJitter",
        "Compose", "ContrastTransform", "Grayscale", "HueTransform",
        "Normalize", "Pad", "RandomAffine", "RandomCrop", "RandomErasing",
        "RandomHorizontalFlip", "RandomPerspective", "RandomResizedCrop",
        "RandomRotation", "RandomVerticalFlip", "Resize",
        "SaturationTransform", "ToTensor", "Transpose", "adjust_brightness",
        "adjust_contrast", "adjust_hue", "adjust_saturation", "affine",
        "center_crop", "crop", "erase", "hflip", "normalize", "pad",
        "perspective", "resize", "rotate", "to_grayscale", "to_tensor_fn",
        "vflip")],
    *[("vision.transforms_functional", n, ()) for n in (
        "normalize", "resize", "hflip", "vflip", "adjust_brightness",
        "adjust_contrast", "adjust_saturation", "adjust_hue",
        "to_grayscale", "crop", "center_crop", "pad", "erase", "affine",
        "rotate", "perspective", "to_tensor")],
    *[("vision.datasets", n, ()) for n in (
        "Cifar10", "Cifar100", "DatasetFolder", "FashionMNIST", "Flowers",
        "ImageFolder", "MNIST", "VOC2012")],
    *[("vision", n, ()) for n in (
        "set_image_backend", "get_image_backend", "image_load")],
    *[("vision.models", n, ()) for n in (
        "AlexNet", "DenseNet", "GoogLeNet", "InceptionV3", "LeNet",
        "MobileNetV1", "MobileNetV2", "MobileNetV3Large", "MobileNetV3Small",
        "ShuffleNetV2", "SqueezeNet", "VGG", "alexnet", "densenet121",
        "densenet161", "densenet169", "densenet201", "densenet264",
        "googlenet", "inception_v3", "mobilenet_v1", "mobilenet_v2",
        "mobilenet_v3_large", "mobilenet_v3_small", "shufflenet_v2_swish",
        "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
        "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
        "squeezenet1_0", "squeezenet1_1", "vgg11", "vgg13", "vgg16",
        "vgg19")],
    *[("nn", n, ()) for n in ("ReLU6", "Hardswish", "Hardsigmoid",
                              "Swish")],
    *[("nn.functional", n, ()) for n in (
        "relu6", "hardswish", "hardsigmoid", "swish", "silu")],
    *[("ops.manipulation", n, ()) for n in (
        "concat", "flatten", "reshape", "transpose", "split")],
]
# torch's own keywords, which torch passes to a Layer's methods itself
# (``named_parameters(remove_duplicate=)``, ``state_dict(prefix=,
# keep_vars=)``, ...), are keyword-only extras too
PORT_ONLY = {"device", "dtype", "recurse", "remove_duplicate", "prefix",
             "keep_vars", "persistent"}


def _both(mod, name):
    """The callable ``name`` (dotted: a class's method) of ``mod`` (empty:
    the package) in the reference and in the port."""
    out = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        obj = importlib.import_module(f"{pkg}.{mod}" if mod else pkg)
        for part in name.split("."):
            obj = getattr(obj, part)
        out.append(obj)
    return tuple(out)


@pytest.mark.parametrize("mod,name,tail", CALLABLES,
                         ids=[f"{m}.{n}" for m, n, _ in CALLABLES])
def test_positional_order_equals_the_reference(mod, name, tail):
    ref, port = (inspect.signature(f).parameters for f in _both(mod, name))
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD)
    want = [(n, p.default) for n, p in ref.items()
            if p.kind in kinds and n not in tail]
    got = [(n, p.default) for n, p in port.items() if p.kind in kinds]
    assert got == want
    assert list(ref)[len(ref) - len(tail):] == list(tail)
    extra = {n for n, p in port.items() if p.kind not in kinds}
    ref_kw = {n for n, p in ref.items() if p.kind not in kinds}
    assert extra - ref_kw <= PORT_ONLY
    for n in extra & PORT_ONLY:
        assert port[n].kind == inspect.Parameter.KEYWORD_ONLY


# ------------------------------------------------------------- layers --

def test_embedding_fourth_positional_is_sparse():
    """``Embedding(10, 4, None, False)``: ``sparse=False`` in both
    packages, an N(0, 1) weight (it was std 0, all zeros)."""
    port = pt.nn.Embedding(10, 4, None, False)
    ref = paddle.nn.Embedding(10, 4, None, False)
    for w in (port.weight.detach().numpy(), np.asarray(ref.weight.numpy())):
        assert w.shape == (10, 4) and np.abs(w).sum() > 0
    padded = pt.nn.Embedding(10, 4, 2, True)
    assert padded._sparse and (padded.weight[2] == 0).all()
    assert (padded(torch.tensor([[2, 3]]))[0, 0] == 0).all()


def test_linear_bias_attr_false_has_no_bias():
    port = pt.nn.Linear(2, 3, bias_attr=False)
    ref = paddle.nn.Linear(2, 3, bias_attr=False)
    assert port.bias is None and ref.bias is None
    assert [n for n, _ in port.named_parameters()] == ["weight"]
    w = np.asarray(ref.weight.numpy())            # [in, out]
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w.T.copy()))
    x = np.random.RandomState(0).randn(5, 2).astype(np.float32)
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(ref(paddle.to_tensor(x)).numpy()), **TOL)


def test_attrs_set_the_draw_and_the_flags():
    """An initializer, a ``ParamAttr`` or a name as ``weight_attr`` /
    ``bias_attr``; ``trainable`` as ``requires_grad``; ``need_clip``,
    ``regularizer`` and ``optimize_attr`` on the parameter, as the
    reference sets them; positional ``weight_attr`` / ``bias_attr``."""
    reg = pt.regularizer.L2Decay(0.1)
    lin = pt.nn.Linear(3, 2, I.Constant(0.5), pt.ParamAttr(
        name="b", initializer=I.Constant(-1.0), learning_rate=0.5,
        regularizer=reg, trainable=False, need_clip=False))
    assert (lin.weight == 0.5).all() and (lin.bias == -1.0).all()
    assert lin.weight.requires_grad and not lin.bias.requires_grad
    assert lin.bias.name == "b" and lin.bias.regularizer is reg
    assert lin.bias.need_clip is False and lin.weight.need_clip is True
    assert lin.bias.optimize_attr == {"learning_rate": 0.5}
    ref = paddle.nn.Linear(3, 2, None, paddle.ParamAttr(
        learning_rate=0.5, trainable=False, need_clip=False))
    assert ref.bias.stop_gradient and ref.bias.need_clip is False
    assert ref.bias.optimize_attr == {"learning_rate": 0.5}
    assert pt.nn.Linear(3, 2, "w").weight.name == "w"
    ln = pt.nn.LayerNorm(4, 1e-5, False, False)
    assert ln.weight is None and ln.bias is None
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    np.testing.assert_allclose(
        ln(torch.from_numpy(x)).numpy(),
        np.asarray(paddle.nn.LayerNorm(4, 1e-5, False, False)(
            paddle.to_tensor(x)).numpy()), **TOL)


def test_attrs_survive_the_encoder_copies():
    """``TransformerEncoder`` deep-copies its layer: the copies keep the
    attributes (torch's own ``Parameter`` copy drops them). The 9th
    positional of ``TransformerEncoderLayer`` is ``weight_attr``."""
    attr = pt.ParamAttr(initializer=I.Constant(0.01), need_clip=False)
    layer = pt.nn.TransformerEncoderLayer(8, 2, 16, 0.0, "relu", None, None,
                                          False, attr)
    enc = pt.nn.TransformerEncoder(layer, 2)
    for m in (enc.layers[0], enc.layers[1]):
        for lin in (m.linear1, m.linear2, m.self_attn.q_proj):
            assert (lin.weight == 0.01).all()
            assert lin.weight.need_clip is False and lin.bias.need_clip
        assert (m.norm1.weight == 1).all()
    assert enc.layers[1].linear1.weight is not enc.layers[0].linear1.weight
    out = enc(torch.randn(2, 5, 8))
    assert out.shape == (2, 5, 8) and torch.isfinite(out).all()


def test_multi_head_attention_kdim_vdim_need_weights():
    mha = pt.nn.MultiHeadAttention(8, 2, 0.0, 6, 5, True)
    assert mha.k_proj.weight.shape == (8, 6)
    assert mha.v_proj.weight.shape == (8, 5)
    out, weights = mha(torch.randn(2, 3, 8), torch.randn(2, 4, 6),
                       torch.randn(2, 4, 5))
    assert out.shape == (2, 3, 8) and weights is None


def test_layer_list_sublayers_keyword():
    ls = pt.nn.LayerList(sublayers=[pt.nn.Linear(2, 2), pt.nn.Dropout(
        0.1, name="d")])
    assert [n for n, _ in ls.named_children()] == ["0", "1"]


def test_set_global_initializer_replaces_layer_defaults_only():
    try:
        I.set_global_initializer(I.Constant(0.25), I.Constant(0.75))
        lin = pt.nn.Linear(2, 3)
        assert (lin.weight == 0.25).all() and (lin.bias == 0.75).all()
        own = pt.nn.Linear(2, 3, weight_attr=I.Constant(2.0))
        assert (own.weight == 2.0).all() and (own.bias == 0.75).all()
    finally:
        I.set_global_initializer(None, None)
    torch.manual_seed(0)
    assert not (pt.nn.Linear(2, 3).weight == 0.25).any()


def test_need_clip_false_is_left_alone_by_the_global_norm_clip():
    """``Linear(2, 3, weight_attr=ParamAttr(need_clip=False))`` under
    ``ClipGradByGlobalNorm``: that gradient is neither clipped nor in the
    norm, in both packages; SGD steps agree."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 2).astype(np.float32)
    ref = [paddle.nn.Linear(2, 3, weight_attr=paddle.ParamAttr(
        need_clip=False)), paddle.nn.Linear(3, 1)]
    port = [pt.nn.Linear(2, 3, weight_attr=pt.ParamAttr(need_clip=False)),
            pt.nn.Linear(3, 1)]
    for r, p in zip(ref, port):
        with torch.no_grad():
            p.weight.copy_(torch.from_numpy(np.array(r.weight.numpy()).T))
            p.bias.copy_(torch.from_numpy(np.array(r.bias.numpy())))
    ref_p = [t for m in ref for t in m.parameters()]
    port_p = [t for m in port for t in m.parameters()]
    ropt = paddle.optimizer.SGD(1.0, parameters=ref_p, grad_clip=(
        paddle.nn.ClipGradByGlobalNorm(0.5, "g", True)))
    popt = pt.optimizer.SGD(1.0, parameters=port_p, grad_clip=(
        pt.nn.ClipGradByGlobalNorm(0.5, "g", True)), name="sgd")
    rloss = (ref[1](ref[0](paddle.to_tensor(x))) ** 2).sum() * 100
    rloss.backward()
    ploss = (port[1](port[0](torch.from_numpy(x))) ** 2).sum() * 100
    ploss.backward()
    raw = port[0].weight.grad.clone()
    w0 = port[0].weight.detach().clone()
    ropt.step()
    popt.step()
    assert torch.equal(port[0].weight.detach(), w0 - raw)   # not clipped
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.weight.detach().numpy().T,
                                   np.asarray(r.weight.numpy()), **TOL)
        np.testing.assert_allclose(p.bias.detach().numpy(),
                                   np.asarray(r.bias.numpy()), **TOL)


def test_param_regularizer_is_read_by_the_optimizer():
    """A ``ParamAttr(regularizer=L2Decay(0.1))`` weight: one SGD step of
    the port equals the reference's."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, 3).astype(np.float32)
    ref = paddle.nn.Linear(3, 2, weight_attr=paddle.ParamAttr(
        regularizer=paddle.regularizer.L2Decay(0.1)))
    port = pt.nn.Linear(3, 2, weight_attr=pt.ParamAttr(
        regularizer=pt.regularizer.L2Decay(0.1)))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(ref.weight.numpy()).T))
        port.bias.copy_(torch.from_numpy(np.array(ref.bias.numpy())))
    ropt = paddle.optimizer.SGD(0.5, parameters=ref.parameters())
    popt = pt.optimizer.SGD(0.5, parameters=list(port.parameters()))
    (ref(paddle.to_tensor(x)) ** 2).sum().backward()
    (port(torch.from_numpy(x)) ** 2).sum().backward()
    ropt.step()
    popt.step()
    np.testing.assert_allclose(port.weight.detach().numpy().T,
                               np.asarray(ref.weight.numpy()), **TOL)


# ---------------------------------------------------- the other calls --

def test_predictor_eleventh_positional_is_max_queue():
    from paddle_tpu.inference import ContinuousBatchingPredictor as Ref
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    args = (None, 2, 8, None, 64, 0, None, None, "auto", True, 7, "oldest")
    for cls in (Ref, ContinuousBatchingPredictor):
        bound = inspect.signature(cls).bind(*args).arguments
        assert bound["max_queue"] == 7 and bound["shed_policy"] == "oldest"
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    cb = ContinuousBatchingPredictor(model, 2, 8, None, 64, 0, None, None,
                                     "auto", True, 7, device="cpu")
    assert cb.max_queue == 7 and cb._chunk_max in (None, 0)


def test_train_step_fifth_positional_is_donate_state():
    """``TrainStep(m, o, f, 1, False)`` trains, step for step as
    ``TrainStep(m, o, f)``."""
    from paddle_tpu_torch.jit import TrainStep
    rng = np.random.RandomState(5)
    x, y = (torch.from_numpy(rng.randn(8, 4).astype(np.float32))
            for _ in range(2))
    runs = []
    for args in ((1, False), ()):
        torch.manual_seed(0)
        m = pt.nn.Linear(4, 4)
        opt = pt.optimizer.Adam(1e-2, parameters=list(m.parameters()),
                                lazy_mode=False, use_multi_tensor=True,
                                name="adam")
        step = TrainStep(m, opt, lambda o, t: ((o - t) ** 2).mean(), *args)
        runs.append([float(step(x, y)) for _ in range(5)])
    assert runs[0] == runs[1] and runs[0][-1] < runs[0][0]


def test_name_keywords_and_fused_layer_norm_axis():
    from paddle_tpu_torch.incubate.nn.functional import fused_layer_norm
    logits, label = torch.randn(3, 5), torch.tensor([1, 0, 4])
    want = pt.nn.functional.cross_entropy(logits, label)
    assert torch.equal(pt.nn.functional.cross_entropy(logits, label,
                                                      name="ce"), want)
    assert torch.equal(pt.nn.CrossEntropyLoss(name="ce")(logits, label),
                       want)
    x, s, b = torch.randn(2, 3, 8), torch.randn(8), torch.randn(8)
    assert torch.equal(fused_layer_norm(x, s, b, 1e-5, begin_norm_axis=2),
                       fused_layer_norm(x, s, b, 1e-5))
    m = pt.nn.Linear(2, 2)
    pt.optimizer.AdamW(parameters=list(m.parameters()), lazy_mode=True,
                       name="w")
    pt.optimizer.Momentum(parameters=list(m.parameters()), name="m")


def test_training_arguments_seed_in_the_reference_place():
    from paddle_tpu.trainer import TrainingArguments as Ref
    from paddle_tpu_torch.trainer import TrainingArguments
    args = ("out", 10, 2, 5, 7, True)
    assert TrainingArguments(*args).seed == Ref(*args).seed == 7
    assert TrainingArguments(*args).bf16 is True


@pytest.mark.parametrize("name,args", [
    ("CosineAnnealingDecay", (0.1, 10, 0.0, -1)),
    ("PolynomialDecay", (0.1, 10, 1e-4, 1.0, False, -1)),
    ("LinearWarmup", (0.1, 4, 0.0, 0.1, -1))])
def test_scheduler_verbose_and_state_dict(name, args):
    """``verbose`` in the reference's place (after ``last_epoch``), and
    its key in ``state_dict``: the port's state equals the reference's
    after a few steps."""
    ref_cls, port_cls = _both("optimizer.lr", name)
    ref, port = ref_cls(*args, True), port_cls(*args, True)
    for _ in range(3):
        ref.step()
        port.step()
    assert port.state_dict() == pytest.approx(ref.state_dict())
    assert port.state_dict()["verbose"] is True


# ------------------------------------------------------- initializers --

def _ref_draw(init, shape):
    import jax.numpy as jnp
    return np.asarray(init(shape, jnp.float32), np.float64)


# (name, constructor arguments, shape): each draw's sample moments
MOMENT_CASES = [
    ("Normal", (0.5, 2.0), (256, 256)),
    ("TruncatedNormal", (0.1, 0.5, -1.5, 2.0), (256, 256)),
    ("Uniform", (-2.0, 3.0), (256, 256)),
    ("XavierNormal", (), (300, 200)),
    ("XavierUniform", (None, None, 2.0), (300, 200)),
    ("KaimingNormal", (), (64, 32, 3, 3)),
    ("KaimingUniform", (None, 0.2, "leaky_relu"), (400, 160)),
    ("XavierUniform", (), (64, 32, 3, 3)),
]


@pytest.mark.parametrize("name,args,shape", MOMENT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(MOMENT_CASES)])
def test_initializer_moments_match_the_reference(name, args, shape):
    """Mean, standard deviation and range of a 65536-element (or larger)
    draw of each port initializer against the reference's: means within
    6 standard errors, standard deviations within 2 %, and the support
    (bounded draws) the same to 2 % of its width."""
    ref_cls, port_cls = _both("nn.initializer", name)
    want = _ref_draw(ref_cls(*args), shape)
    g = torch.Generator().manual_seed(9)
    got = port_cls(*args)(shape, "float32", generator=g).double().numpy()
    assert got.shape == want.shape
    sd = want.std()
    assert abs(got.mean() - want.mean()) <= 6 * sd / np.sqrt(got.size)
    assert got.std() == pytest.approx(sd, rel=0.02)
    if name in ("TruncatedNormal", "Uniform", "XavierUniform",
                "KaimingUniform"):
        width = want.max() - want.min()
        assert got.min() == pytest.approx(want.min(), abs=0.02 * width)
        assert got.max() == pytest.approx(want.max(), abs=0.02 * width)
    again = port_cls(*args)(shape, "float32",
                            generator=torch.Generator().manual_seed(9))
    assert torch.equal(again.double(), torch.from_numpy(got))


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.3,), (3, 4)),
    ("Assign", (np.arange(12.0).reshape(3, 4),), (3, 4)),
    ("Dirac", (2,), (4, 3, 3, 3)),
    ("Bilinear", (), (2, 3, 4, 4)),
    ("constant", (1.5,), (5,))])
def test_initializer_values_equal_the_reference(name, args, shape):
    ref_cls, port_cls = _both("nn.initializer", name)
    np.testing.assert_allclose(port_cls(*args)(shape).numpy(),
                               _ref_draw(ref_cls(*args), shape), rtol=1e-6)


@pytest.mark.parametrize("shape", [(6, 4), (3, 10), (4, 2, 3)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape):
    ref_cls, port_cls = _both("nn.initializer", "Orthogonal")
    for w in (port_cls(2.0)(shape).double().numpy(),
              _ref_draw(ref_cls(2.0), shape)):
        flat = w.reshape(shape[0], -1) / 2.0
        gram = flat.T @ flat if flat.shape[0] >= flat.shape[1] \
            else flat @ flat.T
        np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-5)


def test_calculate_gain_and_param_attr_conversion():
    ref_cls, port_cls = _both("nn.initializer", "calculate_gain")
    for args in (("tanh",), ("relu",), ("leaky_relu", 0.3), ("selu",),
                 ("linear",)):
        assert port_cls(*args) == ref_cls(*args)
    to = I.ParamAttr._to_attr
    assert to(False) is False and to(None).trainable
    assert to("w").name == "w" and isinstance(to(I.Normal()).initializer,
                                              I.Normal)
    with pytest.raises(TypeError):
        to(3)


def test_initializer_uses_only_its_generator():
    """A draw with an explicit generator leaves torch's default one
    where it was."""
    torch.manual_seed(1)
    before = torch.get_rng_state()
    I.Normal()((4, 4), generator=torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), before)
    p = I.create_parameter([3, 2], I.Uniform(), transpose=True,
                           generator=torch.Generator().manual_seed(0))
    q = copy.deepcopy(p)
    assert p.shape == (2, 3) and torch.equal(p, q) and q.need_clip
