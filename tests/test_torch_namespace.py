"""The port's top-level namespace (``paddle_tpu_torch/__init__.py``,
``framework/dtype.py``, ``framework/place.py``, ``tensor.py``,
``autograd``) against the reference's, on the CPU: ``seed`` repeats the
draws; ``to_tensor`` gives the reference's dtypes; ``save`` / ``load``
round-trip a ``Layer``'s state dict; ``no_grad`` works as a context and as
a decorator; ``set_device`` places what is built without a device and is
put back after each test; ``get_device()`` without a GPU raises where the
reference falls back to the CPU (a decided divergence), and the
reference's TPU names raise; every dtype name maps to the reference's,
with its ``finfo`` / ``iinfo``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import dtype as pdtype
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
          "bfloat16", "float32", "float64", "complex64", "complex128",
          "float8_e4m3fn", "float8_e5m2"]


@pytest.fixture
def on_cpu(monkeypatch):
    """``set_device("cpu")`` for one test; the process-wide choice is put
    back after it."""
    monkeypatch.setattr(pplace, "_current", pplace._current)
    pt.set_device("cpu")


def _name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_names_map_to_the_references(name):
    assert _name(getattr(pt, name)) == str(getattr(paddle, name))
    assert pdtype.convert_dtype(name) is getattr(pt, name)


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32", "float64",
                                  "float8_e4m3fn", "float8_e5m2"])
def test_finfo_equals_the_references(name):
    ref, port = paddle.finfo(name), pt.finfo(name)
    for attr in ("bits", "eps", "max", "min", "tiny"):
        assert float(getattr(port, attr)) == float(getattr(ref, attr)), attr


@pytest.mark.parametrize("name", ["uint8", "int8", "int16", "int32", "int64"])
def test_iinfo_equals_the_references(name):
    ref, port = paddle.iinfo(name), pt.iinfo(name)
    assert (port.bits, port.min, port.max) == (ref.bits, ref.min, ref.max)


CASES = {
    "float": (1.5, {}),
    "float_list": ([1.0, 2.0], {}),
    "int": (3, {}),
    "int_list": ([[1, 2], [3, 4]], {}),
    "bool": (True, {}),
    "numpy_f64": (np.ones(3), {}),
    "numpy_f32": (np.ones(3, np.float32), {}),
    "numpy_i32": (np.arange(3, dtype=np.int32), {}),
    "numpy_in_list": ([np.float64(1.0), np.float64(2.0)], {}),
    "dtype_f16": ([1, 2], dict(dtype="float16")),
    "dtype_bf16": (np.ones(2), dict(dtype="bfloat16")),
    "grad": ([1.0, 2.0], dict(stop_gradient=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_to_tensor_takes_the_references_dtypes(case, on_cpu):
    data, kw = CASES[case]
    ref = paddle.to_tensor(data, **kw)
    port = pt.to_tensor(data, **kw)
    assert _name(port.dtype) == str(ref.dtype)
    assert port.device.type == "cpu"
    assert port.requires_grad == (not ref.stop_gradient)
    np.testing.assert_array_equal(
        port.detach().float().numpy() if port.dtype == torch.bfloat16
        else port.detach().numpy(),
        np.asarray(ref.numpy(), dtype=np.float32)
        if port.dtype == torch.bfloat16 else np.asarray(ref.numpy()))


def test_to_tensor_copies_and_takes_place():
    src = torch.ones(2)
    t = pt.to_tensor(src, place="cpu")
    t += 1
    assert (src == 1).all() and (t == 2).all()
    assert pt.to_tensor([1, 2], place=pt.CPUPlace()).dtype == torch.int64


def test_default_dtype_sets_what_python_floats_take(on_cpu):
    assert pt.get_default_dtype() is pt.float32
    try:
        pt.set_default_dtype("float64")
        paddle.set_default_dtype("float64")
        assert _name(pt.to_tensor(1.5).dtype) == \
            str(paddle.to_tensor(1.5).dtype) == "float64"
        assert torch.get_default_dtype() == torch.float32
    finally:
        pt.set_default_dtype("float32")
        paddle.set_default_dtype("float32")
    for pkg in (pt, paddle):
        with pytest.raises(TypeError):
            pkg.set_default_dtype("int32")


def test_seed_repeats_the_draws():
    def draws():
        lin = pt.nn.Linear(4, 3)
        emb = pt.nn.Embedding(5, 2)
        x = torch.ones(16)
        drop = pt.nn.functional.dropout(x, 0.5, training=True)
        from paddle_tpu_torch.framework.random import dropout_seeds
        return [lin.weight.detach().clone(), emb.weight.detach().clone(),
                drop, torch.tensor(dropout_seeds())]
    pt.seed(7)
    first = draws()
    pt.seed(7)
    again = draws()
    pt.seed(8)
    other = draws()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], other[0])


def test_save_load_round_trips_a_layers_state_dict(tmp_path):
    torch.manual_seed(0)
    cfg = LlamaConfig.tiny(dtype="bfloat16")
    src = LlamaForCausalLM(cfg, device="cpu")
    path = str(tmp_path / "llama.pdparams")
    pt.save(src.state_dict(), path)
    loaded = pt.load(path)
    assert list(loaded) == list(src.state_dict())
    dst = LlamaForCausalLM(cfg, device="cpu")
    assert dst.set_state_dict(loaded) == ([], [])
    for k, v in src.state_dict().items():
        assert dst.state_dict()[k].dtype == torch.bfloat16
        assert torch.equal(dst.state_dict()[k], v), k
    flat = pt.load(path, return_numpy=True)
    assert isinstance(flat["llama.norm.weight"], np.ndarray)


def test_no_grad_as_context_and_decorator():
    w = torch.ones(2, requires_grad=True)
    with pt.no_grad():
        assert not pt.is_grad_enabled()
        assert not (w * 2).requires_grad
        with pt.enable_grad():
            assert (w * 2).requires_grad
    assert pt.is_grad_enabled()

    @pt.no_grad()
    def f():
        return w * 2

    @pt.no_grad
    def g():
        return w * 3

    assert not f().requires_grad and not g().requires_grad
    with pt.set_grad_enabled(False):
        assert not (w * 2).requires_grad
    assert pt.is_grad_enabled()
    with paddle.no_grad():
        assert not paddle.is_grad_enabled()


def test_set_device_places_a_model_built_without_a_device(monkeypatch):
    monkeypatch.setattr(pplace, "_current", None)
    place = pt.set_device("cpu")
    assert place == pt.CPUPlace() and pt.get_device() == "cpu"
    model = LlamaForCausalLM(LlamaConfig.tiny())
    assert model.device.type == "cpu"
    assert pt.to_tensor([1.0]).device.type == "cpu"
    monkeypatch.undo()
    assert pplace.current_place() is None


def test_get_device_without_a_gpu_raises(monkeypatch):
    """A decided divergence: the reference's ``get_device()`` falls back to
    the CPU when no accelerator is present; the port's raises, as
    ``resolve_device()`` does, unless ``set_device("cpu")`` chose it."""
    monkeypatch.setattr(pplace, "_current", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.get_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.to_tensor([1.0])
    assert paddle.get_device() == "cpu"
    pt.set_device("cpu")
    assert pt.get_device() == "cpu"


@pytest.mark.parametrize("name", ["tpu", "tpu:0", "xla", "npu"])
def test_set_device_refuses_the_tpu_names(name, monkeypatch):
    monkeypatch.setattr(pplace, "_current", None)
    with pytest.raises(ValueError, match="'gpu'"):
        pt.set_device(name)
    assert pplace.current_place() is None


@pytest.mark.parametrize("name,want", [("gpu", "cuda"), ("gpu:1", "cuda:1"),
                                       ("cuda:2", "cuda:2"), ("cpu", "cpu")])
def test_device_names_map_to_torch(name, want):
    place = pplace._parse_place(name)
    assert place.torch_device == torch.device(want) or name == "gpu"
    assert pplace.to_torch_device(name).type == torch.device(want).type


def test_top_level_names():
    for sub in ("nn", "optimizer", "amp", "jit", "inference", "distributed",
                "incubate", "generation", "observability", "autograd", "io",
                "metric", "vision", "hapi"):
        assert getattr(pt, sub).__name__ == f"paddle_tpu_torch.{sub}"
    assert pt.callbacks is pt.hapi.callbacks
    assert pt.Model is pt.hapi.Model and pt.summary is pt.hapi.summary
    assert pt.vision.resnet50 is pt.vision.models.resnet50
    for name in ("Model", "summary", "flops", "io", "metric", "vision",
                 "callbacks"):
        assert hasattr(paddle, name), name
    assert pt.nn.Layer is pt.nn.layer_base.Layer
    assert pt.in_dynamic_mode() is paddle.in_dynamic_mode() is True
    assert pt.__version__ == paddle.__version__
    assert pt.device_count() == torch.cuda.device_count()
    assert pt.ParamAttr is pt.nn.initializer.ParamAttr
    for name in ("Tensor", "static"):
        assert not hasattr(pt, name), name
    # ops: the five manipulation functions the vision models call so far
    assert sorted(pt.ops.manipulation.__all__) == [
        "concat", "flatten", "reshape", "split", "transpose"]
    assert set(pt.__all__) <= set(dir(pt))


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_vision_io_and_activation_names():
    """The names this slice ports, in both packages: the DataLoader's
    workers, every transform and functional, the datasets, every model
    constructor, and the activations the models use."""
    import paddle_tpu.vision.transforms.functional as RTF

    import paddle_tpu_torch.vision.transforms.functional as PTF
    for name in ("get_worker_info", "multiprocess_reader", "DataLoader"):
        assert hasattr(paddle.io, name) and hasattr(pt.io, name), name
    assert pt.io.get_worker_info() is None
    ref_t = {n for n in _public(paddle.vision.transforms)
             if callable(getattr(paddle.vision.transforms, n)) and
             getattr(getattr(paddle.vision.transforms, n), "__module__",
                     "").startswith("paddle_tpu.vision")}
    assert ref_t and ref_t <= _public(pt.vision.transforms)
    assert set(RTF.__all__) == set(PTF.__all__)
    assert pt.vision.transforms.functional is PTF
    for name in ("MNIST", "FashionMNIST", "Cifar10", "Cifar100",
                 "DatasetFolder", "ImageFolder", "Flowers", "VOC2012",
                 "FakeData"):
        assert hasattr(paddle.vision.datasets, name), name
        assert name in pt.vision.datasets.__all__, name
    ref_m = {n for n in _public(paddle.vision.models)
             if callable(getattr(paddle.vision.models, n))}
    assert ref_m == set(pt.vision.models.__all__)
    ref_v = {n for n in _public(paddle.vision) if n not in ("ops",)}
    assert ref_v <= _public(pt.vision), ref_v - _public(pt.vision)
    for name in ("ReLU6", "Hardswish", "Hardsigmoid", "Swish"):
        assert hasattr(paddle.nn, name) and name in pt.nn.__all__, name
    for name in ("relu6", "hardswish", "hardsigmoid", "swish", "silu"):
        assert hasattr(paddle.nn.functional, name), name
        assert hasattr(pt.nn.functional, name), name


def test_create_parameter_as_the_reference():
    ref = paddle.create_parameter([3, 2], "float32", name="w",
                                  default_initializer=paddle.nn.initializer
                                  .Constant(0.5))
    port = pt.create_parameter([3, 2], "float32", name="w",
                               default_initializer=pt.nn.initializer
                               .Constant(0.5))
    assert port.name == ref.name == "w"
    np.testing.assert_array_equal(port.detach().numpy(),
                                  np.asarray(ref.numpy()))
    assert port.requires_grad and not ref.stop_gradient
    assert pt.create_parameter([2], "float16", attr=False) is None
    assert pt.create_parameter([2], "bfloat16", is_bias=True).dtype == \
        torch.bfloat16
