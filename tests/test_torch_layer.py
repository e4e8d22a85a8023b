"""The port's ``nn.Layer`` (``paddle_tpu_torch/nn/layer_base.py``) and the
models derived from it, against the reference's ``Layer``, on the CPU.

Tiny Llama, GPT, BERT and ERNIE in both packages, the reference's
weights carried into the port by ``convert``: the same ``state_dict()``
keys in the same order, the same sublayer names, the same own
parameters per sublayer, and the same ``(missing, unexpected)`` from
``set_state_dict`` with one key dropped and one added. A wrong shape
raises ``ValueError`` in both. The modes, the forward hooks, the casts
and ``clear_gradients`` behave as the reference's; torch's own callers
(``torch.func.functional_call``, a torch container's ``state_dict`` and
``train``) keep working. The seeded draws of the tiny models are pinned
by SHA-256. The ``Predictor`` loads a port-saved params file through
``set_state_dict``: a file that lacks a key loads the rest in both
packages (the reference's quirk). f32 tolerance: atol = rtol = 1e-5.
"""
import hashlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models as R

import paddle_tpu_torch as pt
import paddle_tpu_torch.models as P
from paddle_tpu_torch.convert import load_reference_state_dict

TOL = dict(atol=1e-5, rtol=1e-5)

MODELS = {
    "llama": (lambda: R.LlamaForCausalLM(R.LlamaConfig.tiny()),
              lambda: P.LlamaForCausalLM(P.LlamaConfig.tiny(), device="cpu")),
    "llama_tied": (
        lambda: R.LlamaForCausalLM(R.LlamaConfig.tiny(
            tie_word_embeddings=True)),
        lambda: P.LlamaForCausalLM(P.LlamaConfig.tiny(
            tie_word_embeddings=True), device="cpu")),
    "gpt": (lambda: R.GPTForCausalLM(R.GPTConfig.tiny()),
            lambda: P.GPTForCausalLM(P.GPTConfig.tiny(), device="cpu")),
    "bert": (lambda: R.BertForSequenceClassification(R.BertConfig.tiny()),
             lambda: P.BertForSequenceClassification(P.BertConfig.tiny(),
                                                     device="cpu")),
    "ernie": (lambda: R.ErnieForSequenceClassification(R.ErnieConfig.tiny(),
                                                       num_classes=3),
              lambda: P.ErnieForSequenceClassification(
                  P.ErnieConfig.tiny(), num_classes=3, device="cpu")),
}


def _ref_state(ref):
    return {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


def _pair(name):
    paddle.seed(0)
    ref = MODELS[name][0]()
    port = MODELS[name][1]()
    load_reference_state_dict(port, _ref_state(ref))
    return ref, port


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return _pair(request.param)


def test_state_dict_keys_equal_the_reference_in_order(pair):
    ref, port = pair
    assert list(port.state_dict()) == list(ref.state_dict())
    params = [n for n, _ in port.named_parameters()]
    persistable = [n for n, _ in port.named_buffers()
                   if not n.rsplit(".", 1)[-1].startswith("rope_")]
    assert sorted(port.state_dict()) == sorted(params + persistable)
    assert not any("rope_" in k for k in port.state_dict())


def test_sublayer_names_equal_the_reference(pair):
    ref, port = pair
    names = [n for n, _ in port.named_sublayers()]
    assert names == [n for n, _ in ref.named_sublayers()]
    assert [n for n, _ in port.named_sublayers(prefix="m",
                                               include_self=True)] == \
        [n for n, _ in ref.named_sublayers(prefix="m", include_self=True)]
    assert port.sublayers(include_self=True)[0] is port
    assert len(port.sublayers()) == len(ref.sublayers())
    assert [n for n, _ in port.named_children()] == \
        [n for n, _ in ref.named_children()]
    assert port.full_name() == ref.full_name()


def test_own_parameters_of_every_sublayer_equal_the_reference(pair):
    ref, port = pair
    for (rn, r), (pn, p) in zip(ref.named_sublayers(include_self=True),
                                port.named_sublayers(include_self=True)):
        assert rn == pn
        assert [n for n, _ in p.named_parameters(include_sublayers=False)] \
            == [n for n, _ in r.named_parameters(include_sublayers=False)]
        assert len(p.parameters(include_sublayers=False)) == \
            len(r.parameters(include_sublayers=False))
    assert isinstance(port.parameters(), list)
    assert len(port.parameters()) == len(ref.parameters())


def test_set_state_dict_returns_the_references_lists(pair):
    ref, port = pair
    keys = list(ref.state_dict())
    dropped = keys[len(keys) // 2]
    rstate = {k: v for k, v in _ref_state(ref).items() if k != dropped}
    rstate["not.a.weight"] = np.zeros((2,), np.float32)
    pstate = {k: v.clone() for k, v in port.state_dict().items()
              if k != dropped}
    pstate["not.a.weight"] = torch.zeros(2)
    assert port.set_state_dict(pstate) == ref.set_state_dict(rstate) == \
        ([dropped], ["not.a.weight"])
    assert port.load_dict(port.state_dict()) == ([], [])


def test_wrong_shape_raises_in_both(pair):
    ref, port = pair
    key = list(ref.state_dict())[0]
    bad = np.zeros((3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        ref.set_state_dict({key: bad})
    with pytest.raises(ValueError, match="shape mismatch"):
        port.set_state_dict({key: torch.from_numpy(bad)})


def test_set_state_dict_writes_in_place_and_casts():
    """Every parameter keeps its tensor and storage (graphs read by
    address), its version counter moves (the prefix cache's flush), and a
    f32 source lands in a bf16 model as bf16."""
    torch.manual_seed(0)
    src = P.LlamaForCausalLM(P.LlamaConfig.tiny(), device="cpu")
    dst = P.LlamaForCausalLM(P.LlamaConfig.tiny(dtype="bfloat16"),
                             device="cpu")
    before = {n: (p, p.data_ptr(), p._version)
              for n, p in dst.named_parameters()}
    assert dst.set_state_dict(src.state_dict()) == ([], [])
    for n, p in dst.named_parameters():
        t, ptr, ver = before[n]
        assert p is t and p.data_ptr() == ptr and p._version > ver
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, src.state_dict()[n].to(torch.bfloat16))


def test_train_and_eval_set_every_sublayer(pair):
    ref, port = pair
    for mode in ("eval", "train", "eval"):
        getattr(port, mode)()
        getattr(ref, mode)()
        want = mode == "train"
        assert all(m.training is want for m in port.sublayers(True))
        assert [m.training for m in port.sublayers()] == \
            [m.training for m in ref.sublayers()]


def test_forward_hooks_fire_once_per_call_and_stop_after_remove():
    for pkg in (paddle, pt):
        lin = pkg.nn.Linear(3, 2)
        seen = []
        pre = lin.register_forward_pre_hook(
            lambda layer, inputs: seen.append(("pre", layer is lin)))
        post = lin.register_forward_post_hook(
            lambda layer, inputs, out: out * 2)
        x = np.ones((1, 3), np.float32)
        xs = paddle.to_tensor(x) if pkg is paddle else torch.from_numpy(x)
        hooked = np.asarray(lin(xs).numpy() if pkg is paddle
                            else lin(xs).detach().numpy())
        assert seen == [("pre", True)]
        pre.remove()
        post.remove()
        plain = np.asarray(lin(xs).numpy() if pkg is paddle
                           else lin(xs).detach().numpy())
        assert seen == [("pre", True)]
        np.testing.assert_allclose(hooked, 2 * plain, **TOL)


class _IntBuffer:
    """A Linear with an int64 and a f32 buffer, in either package."""

    @staticmethod
    def build(pkg):
        lin = pkg.nn.Linear(3, 2)
        if pkg is paddle:
            lin.register_buffer("steps", paddle.to_tensor(
                np.arange(3, dtype=np.int64)))
            lin.register_buffer("scale", paddle.to_tensor(
                np.ones(2, np.float32)))
        else:
            lin.register_buffer("steps", torch.arange(3))
            lin.register_buffer("scale", torch.ones(2))
        return lin


@pytest.mark.parametrize("cast", ["float16", "astype_bfloat16", "bfloat16",
                                  "float"])
def test_casts_change_floating_tensors_only(cast):
    name = {"float16": "float16", "astype_bfloat16": "bfloat16",
            "bfloat16": "bfloat16", "float": "float32"}[cast]
    for pkg in (paddle, pt):
        lin = _IntBuffer.build(pkg)
        if cast == "astype_bfloat16":
            out = lin.astype("bfloat16")
        else:
            out = getattr(lin.float16() if cast == "float" else lin, cast)()
        assert out is lin
        dt = {n: str(t.dtype).replace("torch.", "")
              for n, t in lin.state_dict().items()}
        assert dt == {"weight": name, "bias": name, "steps": "int64",
                      "scale": name}, (pkg.__name__, dt)


def test_to_takes_a_device_a_dtype_or_both():
    lin = pt.nn.Linear(3, 2)
    w = lin.weight
    assert lin.to("cpu") is lin and lin.weight is w
    assert lin.to(dtype="float16").weight.dtype == torch.float16
    assert lin.to(torch.bfloat16).bias.dtype == torch.bfloat16
    assert lin.to(pt.CPUPlace(), "float32").weight.dtype == torch.float32
    assert lin.weight is w


def test_clear_gradients_leaves_no_grad():
    paddle.seed(0)
    ref, port = _pair("gpt")
    ids = np.random.RandomState(0).randint(1, 500, (2, 6))
    port(torch.from_numpy(ids)).sum().backward()
    assert all(p.grad is not None for p in port.parameters())
    port.clear_gradients()
    assert all(p.grad is None for p in port.parameters())


def test_torch_callers_keep_working():
    """``torch.func.functional_call`` (which asks for
    ``named_parameters(remove_duplicate=False)``), a torch container's
    ``state_dict(prefix=, keep_vars=)`` recursion and its positional
    ``train(False)``, and ``Module.eval`` over ``Layer``s."""
    torch.manual_seed(0)
    model = P.LlamaForCausalLM(P.LlamaConfig.tiny(tie_word_embeddings=True),
                               device="cpu").eval()
    ids = torch.randint(1, 256, (2, 5))
    state = {n: t * 0.5 for n, t in model.state_dict(keep_vars=True).items()}
    with torch.no_grad():
        got = torch.func.functional_call(model, state, (ids,))
        other = P.LlamaForCausalLM(P.LlamaConfig.tiny(
            tie_word_embeddings=True), device="cpu").eval()
        other.set_state_dict(state)
        np.testing.assert_allclose(got.numpy(), other(ids).numpy(), **TOL)
    assert len(dict(model.named_parameters(remove_duplicate=False))) == \
        len(model.parameters())
    box = torch.nn.Sequential(model)
    sd = box.state_dict(keep_vars=True)
    assert list(sd) == ["0." + k for k in model.state_dict()]
    assert all(sd["0." + n] is p for n, p in model.named_parameters())
    box.train(False)
    assert not any(m.training for m in model.sublayers(True))
    box.train()
    assert all(m.training for m in model.sublayers(True))
    box.eval()
    assert not model.training


def test_a_layer_built_from_the_base_matches_the_reference():
    """A subclass of each package's ``Layer`` with ``create_parameter``,
    ``add_parameter``, ``add_sublayer`` and a persistable and a
    non-persistable buffer: the same state dict names, dtypes and
    lists."""
    def build(pkg):
        class Block(pkg.nn.Layer):
            def __init__(self):
                super().__init__(dtype="float32")
                self.w = self.create_parameter([3, 4])
                self.add_parameter("b", self.create_parameter(
                    [4], is_bias=True))
                self.add_sublayer("proj", pkg.nn.Linear(4, 2))
                self.register_buffer("count", pkg.to_tensor(
                    np.zeros(1, np.float32)) if pkg is paddle
                    else torch.zeros(1))
                self.register_buffer("table", pkg.to_tensor(
                    np.ones(2, np.float32)) if pkg is paddle
                    else torch.ones(2), persistable=False)
        return Block()
    ref, port = build(paddle), build(pt)
    assert list(port.state_dict()) == list(ref.state_dict()) == \
        ["w", "b", "count", "proj.weight", "proj.bias"]
    assert [n for n, _ in port.named_buffers()] == \
        [n for n, _ in ref.named_buffers()]
    assert port.full_name() == ref.full_name() == "block"
    assert (port.b == 0).all() and port.w.dtype == torch.float32
    assert list(port.state_dict(include_sublayers=False)) == \
        list(ref.state_dict(include_sublayers=False)) == ["w", "b", "count"]
    assert list(port.state_dict(structured_name_prefix="m.")) == \
        list(ref.state_dict(structured_name_prefix="m."))


def test_reference_linear_layout_raises_on_the_shape():
    """A decided divergence: the port's ``Linear.weight`` is [out, in],
    the reference's [in, out]; ``set_state_dict`` takes the port's layout
    and raises on the reference's (``convert.load_reference_state_dict``
    transposes)."""
    paddle.seed(0)
    ref = paddle.nn.Linear(3, 5)
    port = pt.nn.Linear(3, 5)
    with pytest.raises(ValueError, match="shape mismatch for weight"):
        port.set_state_dict(_ref_state(ref))
    load_reference_state_dict(port, _ref_state(ref))
    np.testing.assert_array_equal(port.weight.detach().numpy().T,
                                  np.asarray(ref.weight.numpy()))


def test_predictor_loads_a_partial_params_file_as_the_reference(tmp_path):
    """The reference's ``Predictor`` loads a params file through
    ``set_state_dict`` and drops its lists: a file without
    ``classifier.bias`` loads every other weight and leaves that one as
    the factory built it, in both packages; the port's output equals the
    reference's."""
    from paddle_tpu.inference import Config as RefConfig
    from paddle_tpu.inference import create_predictor as ref_create
    from paddle_tpu_torch.inference import Config, create_predictor
    ref, port = _pair("ernie")
    ref.eval()
    port.eval()
    drop = "classifier.bias"
    paddle.seed(1)
    rfresh = MODELS["ernie"][0]()
    pfresh = MODELS["ernie"][1]()
    bias = np.full((3,), 0.25, np.float32)
    rfresh.set_state_dict({drop: bias})
    pfresh.set_state_dict({drop: torch.from_numpy(bias)})
    rpath, ppath = str(tmp_path / "ref.pdparams"), str(tmp_path / "p.pdparams")
    paddle.save({k: v for k, v in ref.state_dict().items() if k != drop},
                rpath)
    pt.save({k: v for k, v in port.state_dict().items() if k != drop}, ppath)
    rcfg = RefConfig(params_file=rpath)
    rcfg.set_model_factory(lambda: rfresh)
    cfg = Config(params_file=ppath)
    cfg.disable_gpu()
    cfg.set_model_factory(lambda: pfresh)
    x = np.random.RandomState(0).randint(1, 256, (2, 8))
    want = np.asarray(ref_create(rcfg).run([x])[0])
    got = create_predictor(cfg).run([x])[0]
    for k, v in port.state_dict().items():
        if k != drop:
            assert torch.equal(pfresh.state_dict()[k], v), k
    np.testing.assert_array_equal(pfresh.classifier.bias.detach().numpy(),
                                  bias)
    np.testing.assert_array_equal(np.asarray(rfresh.classifier.bias.numpy()),
                                  bias)
    np.testing.assert_allclose(got, want, **TOL)


def test_train_keeps_torchs_positional_mode():
    """``train`` takes the reference's call (no argument) and torch's
    positional ``mode``, which torch's containers pass; every other
    ``Layer`` method is pinned in test_torch_signatures.py."""
    import inspect
    from paddle_tpu.nn.layer_base import Layer as RefLayer
    ref = list(inspect.signature(RefLayer.train).parameters)
    port = list(inspect.signature(pt.nn.Layer.train).parameters)
    assert port[:len(ref)] == ref and port[len(ref):] == ["mode"]


# SHA-256 of the tiny models' state dicts (keys sorted; bf16 as its bits),
# computed on the tree before the models derived from Layer: (built after
# torch.manual_seed(0), then after init_weights(Generator().manual_seed(0)))
SEEDED = {
    "llama": ("643f521ff6d192072ba810bc52d9d64144dc9b936ae4b879aaf620ac27735f00",
              "a64f71e1d9dded22daae5007590710654d5de1f3d0ea56eda399b42ef657fac3"),
    "llama_bf16": (
        "dd5377c0fd91d393c3e09629ff86932ee131c3c49d0fc7522855f933ad005103",
        "7000fab79fe4a9c19b50289d574a16ea1ad2f3a06017fe7daca65a752b6ee248"),
    "gpt": ("1090d5fbfe7306f08d4b33c02021e694d4e55da3479d81ae05571702b729181b",
            "7e26267eafa733b20fab14ea58a827661740109beb335b3b8d20e8673dd0009a"),
    "bert": ("54e98432c6fbe8c1f628acd8a17b5428a573c4ed95c8fd592464df67aeadf326",
             "f41bb94925cf575189c13fc14ee132eb5195dec6f1e8a6dd38dd6b6d93a333c7"),
    "ernie": ("b5d1d21710dff75fa74e729a307553072eef03217807a23e57a189c9c2c9ecfa",
              "4be043783a4bcaf312ab12021ffa1fe75f0c015c5f436856ac29359c9a02249d"),
}
BUILDS = dict(
    llama=MODELS["llama"][1], gpt=MODELS["gpt"][1], bert=MODELS["bert"][1],
    ernie=MODELS["ernie"][1],
    llama_bf16=lambda: P.LlamaForCausalLM(P.LlamaConfig.tiny(
        dtype="bfloat16"), device="cpu"))


def _digest(model):
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(k.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", list(SEEDED))
def test_seeded_draws_are_unchanged(name):
    torch.manual_seed(0)
    model = BUILDS[name]()
    built = _digest(model)
    model.init_weights(torch.Generator().manual_seed(0))
    assert (built, _digest(model)) == SEEDED[name]
