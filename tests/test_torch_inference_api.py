"""The port's Paddle Inference API and ``jit.save`` / ``jit.load``
(``paddle_tpu_torch/inference/api.py``, ``jit/api.py``,
``framework_io.py``, and the kernels' ``torch.library`` custom ops)
against the reference's, on the CPU.

A tiny ERNIE with the reference's weights (``convert``) runs through the
port's ``Config`` / ``create_predictor`` from a model factory and a
``params_file`` (the port's own ``framework_io.save`` file, and a
``.pdiparams`` the reference's ``jit.save`` wrote), through the
zero-copy handles and in bf16; its outputs must equal the reference
``Predictor``'s within atol = rtol = 1e-4 in f32 (sums in other orders),
bf16 within atol 3e-2, rtol 2e-2 (both round weights and activations
to bf16, at other places). A port ``jit.save`` artifact runs in a fresh
process without the model's module, equal to the live model; a port
``.pdiparams`` loaded into a reference model gives the reference's
outputs. The ``cuda`` case exports on the card and counts the kernels a
loaded program launches; the module imports nothing of JAX.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch import framework_io, jit
from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.inference import (Config, PlaceType, PrecisionType,
                                        convert_to_mixed_precision,
                                        create_predictor)
from paddle_tpu_torch.kernels import (attention, launch_counts, norm,
                                      reset_launch_counts)
from paddle_tpu_torch.models import (ErnieConfig,
                                     ErnieForSequenceClassification,
                                     LlamaConfig, LlamaForCausalLM)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=2e-2)
B, S = 3, 16


@pytest.fixture(scope="module")
def ref():
    import paddle_tpu as paddle
    from paddle_tpu import inference, models
    return paddle, inference, models


def _ernie_pair(ref):
    paddle, _, RM = ref
    paddle.seed(0)
    r = RM.ErnieForSequenceClassification(RM.ErnieConfig.tiny(),
                                          num_classes=3)
    r.eval()
    p = ErnieForSequenceClassification(ErnieConfig.tiny(), num_classes=3,
                                       device="cpu")
    load_reference_state_dict(
        p, {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()})
    return r, p.eval()


def _ids(seed=0, b=B):
    return np.random.RandomState(seed).randint(1, 256, (b, S))


def _ref_run(ref, model, x, precision=None):
    _, inference, _ = ref
    cfg = inference.Config()
    if precision:
        cfg.enable_xla(precision=precision)
    cfg.set_model_factory(lambda: model)
    return np.asarray(inference.create_predictor(cfg).run([x])[0])


def _port_config(model, params=None, precision=None):
    cfg = Config(params_file=params)
    cfg.disable_gpu()
    if precision:
        cfg.enable_xla(precision=precision)
    cfg.set_model_factory(lambda: model)
    return cfg


def test_factory_with_port_params_file(ref, tmp_path):
    r, p = _ernie_pair(ref)
    x = _ids()
    want = _ref_run(ref, r, x)
    path = str(tmp_path / "ernie.pdparams")
    framework_io.save(p.state_dict(), path)
    fresh = ErnieForSequenceClassification(ErnieConfig.tiny(), num_classes=3,
                                           device="cpu")
    got = create_predictor(_port_config(fresh, path)).run([x])[0]
    np.testing.assert_allclose(got, want, **TOL)


def test_factory_with_reference_pdiparams(ref, tmp_path):
    paddle = ref[0]
    r, _ = _ernie_pair(ref)
    x = _ids(1)
    want = _ref_run(ref, r, x)
    path = str(tmp_path / "ref_ernie")
    paddle.jit.save(r, path)          # no input_spec: weights and meta
    fresh = ErnieForSequenceClassification(ErnieConfig.tiny(), num_classes=3,
                                           device="cpu")
    got = create_predictor(_port_config(fresh, path + ".pdiparams")).run([x])
    np.testing.assert_allclose(got[0], want, **TOL)


def test_zero_copy_handles(ref):
    r, p = _ernie_pair(ref)
    x = _ids(2)
    pred = create_predictor(_port_config(p))
    assert pred.get_input_names()[:2] == ["x0", "x1"]
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(x)
    assert pred.run() is True
    names = pred.get_output_names()
    assert names == ["out0"]
    out = pred.get_output_handle(names[0]).copy_to_cpu()
    np.testing.assert_allclose(out, _ref_run(ref, r, x), **TOL)


def test_bf16_precision_casts_the_layer(ref):
    r, p = _ernie_pair(ref)
    x = _ids(3)
    want = _ref_run(ref, r, x, PrecisionType.Bfloat16)
    pred = create_predictor(_port_config(p, precision=PrecisionType.Bfloat16))
    assert p.classifier.weight.dtype == torch.bfloat16
    got = pred.run([x])[0]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_port_pdiparams_into_a_reference_model(ref, tmp_path):
    paddle, _, RM = ref
    r, p = _ernie_pair(ref)
    x = _ids(4)
    want = _ref_run(ref, r, x)
    path = str(tmp_path / "port_ernie")
    jit.save(p, path)
    paddle.seed(5)                    # other weights until the load
    r2 = RM.ErnieForSequenceClassification(RM.ErnieConfig.tiny(),
                                           num_classes=3)
    r2.eval()
    with open(path + ".pdiparams", "rb") as f:
        state = pickle.load(f)
    missing, unexpected = r2.set_state_dict(
        {k: paddle.to_tensor(v) for k, v in state.items()})
    assert not missing and not unexpected
    np.testing.assert_allclose(_ref_run(ref, r2, x), want, **TOL)


def test_save_without_spec_writes_weights_and_meta_only(tmp_path):
    p = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").eval()
    path = str(tmp_path / "m")
    jit.save(p, path)
    assert sorted(os.listdir(tmp_path)) == ["m.pdiparams", "m.pdmodel"]
    with open(path + ".pdmodel", "rb") as f:
        assert pickle.load(f)["bf16_keys"] == []
    loaded = jit.load(path)
    assert isinstance(loaded, jit.TranslatedLayer)
    ids = torch.randint(1, 256, (2, 7))
    with torch.no_grad():
        torch.testing.assert_close(loaded(ids), p(ids), rtol=0, atol=0)


def test_failed_export_warns(tmp_path):
    p = ErnieForSequenceClassification(ErnieConfig.tiny(), device="cpu")
    path = str(tmp_path / "bad")
    with pytest.warns(UserWarning, match="export failed"):
        jit.save(p, path, input_spec=[jit.InputSpec([2, S], "float32")])
    assert not os.path.exists(path + ".pt2")
    assert os.path.exists(path + ".pdiparams")


@pytest.mark.parametrize("spec", [[B, S], [None, S]])
def test_exported_program_equals_live(tmp_path, spec):
    """Also the divergence: the port exports a ``None`` batch dim, which
    the reference's ``jax.export`` of ERNIE refuses."""
    p = ErnieForSequenceClassification(ErnieConfig.tiny(), device="cpu")
    p.eval()
    path = str(tmp_path / "ernie")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        jit.save(p, path, input_spec=[jit.InputSpec(spec, "int64", "ids")])
    loaded = jit.load(path, device="cpu")
    assert isinstance(loaded, jit.AOTLayer)
    for b in ([B] if spec[0] else [B, 5]):
        ids = torch.from_numpy(_ids(b, b))
        with torch.no_grad():
            torch.testing.assert_close(loaded(ids), p(ids), rtol=0, atol=0)


def test_exported_llama_ships_rope_tables_and_bf16(tmp_path):
    p = LlamaForCausalLM(LlamaConfig.tiny(dtype="bfloat16"), device="cpu")
    p.init_weights(torch.Generator().manual_seed(0)).eval()
    path = str(tmp_path / "llama")
    jit.save(p, path, input_spec=[jit.InputSpec([1, 12], "int64")])
    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    assert "lm_head.weight" in meta["bf16_keys"]
    with open(path + ".pdiparams", "rb") as f:
        assert pickle.load(f)["lm_head.weight"].dtype == np.uint16
    ids = torch.randint(1, 256, (1, 12))
    cfg = Config(path + ".pdmodel")
    cfg.disable_gpu()
    got = create_predictor(cfg).run([ids.numpy()])[0]
    with torch.no_grad():
        want = p(ids).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_fresh_process_runs_the_artifact_without_the_model(tmp_path):
    p = ErnieForSequenceClassification(ErnieConfig.tiny(), device="cpu")
    p.eval()
    path = str(tmp_path / "ernie")
    jit.save(p, path, input_spec=[jit.InputSpec([None, S], "int64")])
    x = _ids(6)
    with torch.no_grad():
        np.save(tmp_path / "ref.npy", p(torch.from_numpy(x)).numpy())
    np.save(tmp_path / "x.npy", x)
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from paddle_tpu_torch import jit
        from paddle_tpu_torch.inference import Config, create_predictor
        x = np.load({str(tmp_path / 'x.npy')!r})
        ref = np.load({str(tmp_path / 'ref.npy')!r})
        out = jit.load({path!r}, device="cpu")(x).numpy()
        np.testing.assert_array_equal(out, ref)
        cfg = Config({path!r} + ".pdmodel")
        cfg.disable_gpu()
        np.testing.assert_array_equal(create_predictor(cfg).run([x])[0], ref)
        assert not any(m.startswith("paddle_tpu_torch.models")
                       for m in sys.modules), "model module imported"
        assert "jax" not in sys.modules
        print("FRESH_PROCESS_OK")
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert "FRESH_PROCESS_OK" in r.stdout, r.stderr[-3000:]


def test_custom_ops_plain_and_fake():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, generator=g)
    w = torch.randn(64, generator=g)
    ops = torch.ops.paddle_tpu_torch
    torch.testing.assert_close(ops.rms_norm(x, w, 1e-6),
                               norm.rms_norm_plain(x, w, 1e-6))
    torch.testing.assert_close(ops.layer_norm(x, w, w, 1e-5),
                               norm.layer_norm_plain(x, w, w, 1e-5))
    q = torch.randn(2, 3, 4, 64, generator=g)
    k = torch.randn(2, 7, 2, 64, generator=g)
    out, lse = ops.flash_fwd(q, k, k, None, None, 0.125, False)
    want, want_lse = attention.flash_attention_plain(q, k, k, 0.125,
                                                     return_lse=True)
    torch.testing.assert_close(out, want)
    torch.testing.assert_close(lse, want_lse)
    meta = [t.to("meta") for t in (q, k)]
    fo, fl = ops.flash_fwd(meta[0], meta[1], meta[1], None, None, 0.125,
                           True)
    assert (fo.shape, fo.dtype) == (out.shape, out.dtype)
    assert (fl.shape, fl.dtype) == (lse.shape, lse.dtype)
    assert ops.rms_norm(x.to("meta"), w.to("meta"), 1e-6).shape == x.shape


def test_training_path_keeps_the_autograd_function():
    q = torch.randn(1, 4, 2, 64, requires_grad=True)
    out = attention.flash_attention_bshd(q, q.detach(), q.detach())
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    x = torch.randn(3, 8, requires_grad=True)
    y = norm.fused_rms_norm(x, torch.ones(8))
    assert type(y.grad_fn.next_functions[0][0]).__name__ == \
        "_RMSNormBackward"
    y.sum().backward()
    assert x.grad is not None


def test_config_surface_and_device_rule(monkeypatch):
    cfg = Config()
    assert cfg._device == PlaceType.GPU
    cfg.enable_use_gpu(100, 0, PrecisionType.Half)
    assert cfg._precision == PrecisionType.Half
    cfg.enable_tensorrt_engine(precision_mode=PrecisionType.Bfloat16)
    assert cfg._precision == PrecisionType.Bfloat16
    cfg.set_model("a.pdmodel", "a.pdiparams")
    assert (cfg.prog_file, cfg.params_file) == ("a.pdmodel", "a.pdiparams")
    cfg.enable_memory_optim()
    cfg.switch_ir_optim()
    cfg.set_cpu_math_library_num_threads(2)
    cfg.enable_compile_cache("/nonexistent")
    assert cfg.model_dir() is None
    with pytest.raises(NotImplementedError):
        convert_to_mixed_precision()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    cfg.set_model_factory(lambda: torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_predictor(cfg)
    cfg.disable_gpu()
    assert create_predictor(cfg).run([np.ones((1, 2), np.float32)])
    with pytest.raises(RuntimeError, match="jit.save"):
        c2 = Config("nowhere.pdmodel")
        c2.disable_gpu()
        create_predictor(c2)


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_exported_program_launches_the_kernels_on_the_card(cuda, tmp_path):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=512)
    p = LlamaForCausalLM(cfg, device=cuda).init_weights(
        torch.Generator(device=cuda).manual_seed(0)).eval()
    path = str(tmp_path / "llama")
    jit.save(p, path, input_spec=[jit.InputSpec([2, 32], "int64")])
    loaded = jit.load(path)
    ids = torch.randint(1, 256, (2, 32), device=cuda)
    reset_launch_counts()
    got = loaded(ids)
    torch.cuda.synchronize()
    layers = cfg.num_hidden_layers
    assert launch_counts["rms_norm"] == 2 * layers + 1
    assert launch_counts["flash_fwd"] == layers
    with torch.no_grad():
        torch.testing.assert_close(got, p(ids), rtol=0, atol=0)
