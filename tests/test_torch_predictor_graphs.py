"""The inference API's ``Predictor``: one CUDA graph per input signature.

On the CPU the route stays eager: outputs equal the layer's own, through
``run`` and the zero-copy handles alike, and no graph is captured. The
reference binds a signature's weights at its first compile, so a later
in-place ``set_state_dict`` is not seen by that signature; the port's
``Predictor`` reads its layer's tensors (on the card, its graph reads
them by address), so an in-place load is seen at the next call: that
divergence is pinned here against the reference. The ``cuda`` cases hold
the captured route to the eager first call bit for bit with equal kernel
launches per replay, one capture per signature (a ``None`` batch
dimension at batch 16 and 5 is two), the handles reaching the same
cache, a rebound weight re-capturing and an in-place load replaying.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import (ErnieConfig,
                                     ErnieForSequenceClassification,
                                     LlamaConfig, LlamaForCausalLM)

S = 16
TOL = dict(atol=1e-4, rtol=1e-4)


def _ids(seed, b):
    return np.random.RandomState(seed).randint(1, 256, (b, S))


def _cpu_predictor(model):
    cfg = Config()
    cfg.disable_gpu()
    cfg.set_model_factory(lambda: model)
    return create_predictor(cfg)


def test_cpu_route_stays_eager_through_run_and_handles():
    p = ErnieForSequenceClassification(ErnieConfig.tiny(), num_classes=3,
                                       device="cpu").eval()
    pred = _cpu_predictor(p)
    for b in (3, 5, 3):
        x = _ids(b, b)
        with torch.no_grad():
            want = p(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(pred.run([x])[0], want)
        h = pred.get_input_handle(pred.get_input_names()[0])
        h.copy_from_cpu(x)
        assert pred.run() is True
        np.testing.assert_array_equal(
            pred.get_output_handle("out0").copy_to_cpu(), want)
    assert pred.graph_stats == {"captures": 0, "replays": 0,
                                "recaptures": 0, "capture_s": 0.0}
    assert pred._graphs == {}


def test_in_place_load_is_seen_where_the_reference_binds_at_compile():
    """The pinned divergence: after an in-place load into the layer, the
    reference's compiled signature still serves the old weights; the
    port's next call serves the new ones."""
    import paddle_tpu as paddle
    from paddle_tpu import inference as ref_inf
    from paddle_tpu import models as RM
    paddle.seed(0)
    r = RM.ErnieForSequenceClassification(RM.ErnieConfig.tiny(),
                                          num_classes=3)
    r.eval()
    paddle.seed(1)
    r2 = RM.ErnieForSequenceClassification(RM.ErnieConfig.tiny(),
                                           num_classes=3)
    sd = {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()}
    sd2 = {k: np.asarray(v.numpy()) for k, v in r2.state_dict().items()}
    p = ErnieForSequenceClassification(ErnieConfig.tiny(), num_classes=3,
                                       device="cpu").eval()
    load_reference_state_dict(p, sd)
    rcfg = ref_inf.Config()
    rcfg.set_model_factory(lambda: r)
    rpred = ref_inf.create_predictor(rcfg)
    pred = _cpu_predictor(p)
    x = _ids(0, 3)
    old_ref = np.asarray(rpred.run([x])[0])
    old = pred.run([x])[0]
    np.testing.assert_allclose(old, old_ref, **TOL)
    r.set_state_dict(sd2)
    load_reference_state_dict(p, sd2)          # in place (copy_)
    np.testing.assert_array_equal(np.asarray(rpred.run([x])[0]), old_ref)
    new = pred.run([x])[0]
    with torch.no_grad():
        np.testing.assert_array_equal(new, p(torch.from_numpy(x)).numpy())
    assert np.abs(new - old).max() > 1e-3
    # a new signature compiles against the reference's new weights
    x5 = _ids(1, 5)
    np.testing.assert_allclose(pred.run([x5])[0],
                               np.asarray(rpred.run([x5])[0]), **TOL)


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_ernie(dev, seed=0):
    """f32 ERNIE with head_dim 64 (the flash kernel's)."""
    cfg = ErnieConfig.tiny(hidden_size=128, num_attention_heads=2,
                           intermediate_size=256)
    torch.manual_seed(seed)
    return ErnieForSequenceClassification(cfg, num_classes=3,
                                          device=dev).eval()


def _card_predictor(model):
    cfg = Config()
    cfg.set_model_factory(lambda: model)
    return create_predictor(cfg)


def _launches(fn):
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts.items() if v}


@pytest.mark.cuda
def test_replay_equals_the_eager_first_call(cuda):
    model = _card_ernie(cuda)
    pred = _card_predictor(model)
    x = _ids(0, 4)
    with torch.no_grad():
        live, live_n = _launches(
            lambda: model(torch.from_numpy(x).to(cuda)).cpu().numpy())
    first, first_n = _launches(lambda: pred.run([x])[0])
    assert pred.graph_stats["captures"] == 1
    np.testing.assert_array_equal(first, live)
    assert first_n == live_n and live_n["layer_norm"] > 0 \
        and live_n["flash_fwd"] > 0
    for _ in range(3):
        again, n = _launches(lambda: pred.run([x])[0])
        np.testing.assert_array_equal(again, first)
        assert n == live_n
    assert pred.graph_stats["replays"] == 3
    # another input of the same signature replays with its own values
    y = _ids(1, 4)
    with torch.no_grad():
        want = model(torch.from_numpy(y).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(pred.run([y])[0], want)
    assert pred.graph_stats["captures"] == 1


@pytest.mark.cuda
def test_one_capture_per_signature_of_an_exported_program(cuda, tmp_path):
    """A ``None`` batch dim: batch 16 and batch 5 are two signatures, each
    captured once; the handles API reaches the same cache."""
    model = _card_ernie(cuda)
    path = str(tmp_path / "ernie")
    jit.save(model, path, input_spec=[jit.InputSpec([None, S], "int64")])
    pred = create_predictor(Config(path + ".pdmodel"))
    outs = {}
    for b in (16, 5, 16, 5):
        x = _ids(b, b)
        got = pred.run([x])[0]
        with torch.no_grad():
            want = model(torch.from_numpy(x).to(cuda)).cpu().numpy()
        np.testing.assert_array_equal(got, outs.setdefault(b, got))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert pred.graph_stats["captures"] == 2
    assert pred.graph_stats["replays"] == 2
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(_ids(16, 16))
    assert pred.run() is True
    np.testing.assert_array_equal(
        pred.get_output_handle("out0").copy_to_cpu(), outs[16])
    assert pred.graph_stats["captures"] == 2
    assert pred.graph_stats["replays"] == 3


@pytest.mark.cuda
def test_rebind_recaptures_and_in_place_load_replays(cuda):
    model = _card_ernie(cuda)
    other = _card_ernie(cuda, seed=1)
    pred = _card_predictor(model)
    x = _ids(2, 4)
    first = pred.run([x])[0]
    # in place: the graph reads the new values by address
    model.load_state_dict(other.state_dict())
    with torch.no_grad():
        want = model(torch.from_numpy(x).to(cuda)).cpu().numpy()
    got = pred.run([x])[0]
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - first).max() > 1e-4
    assert pred.graph_stats["captures"] == 1
    assert pred.graph_stats["replays"] == 1
    # rebound: another tensor, so the signature is captured again
    w = model.classifier.weight
    model.classifier.weight = torch.nn.Parameter(w.detach() * 2)
    with torch.no_grad():
        want = model(torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(pred.run([x])[0], want)
    assert pred.graph_stats["recaptures"] == 1
    assert pred.graph_stats["captures"] == 2
    np.testing.assert_array_equal(pred.run([x])[0], want)
    assert pred.graph_stats["replays"] == 2


@pytest.mark.cuda
def test_llama_artifact_replays_rms_norm_and_flash(cuda, tmp_path):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=512)
    p = LlamaForCausalLM(cfg, device=cuda).init_weights(
        torch.Generator(device=cuda).manual_seed(0)).eval()
    path = str(tmp_path / "llama")
    jit.save(p, path, input_spec=[jit.InputSpec([1, 32], "int64")])
    pred = create_predictor(Config(path + ".pdmodel"))
    ids = np.random.RandomState(0).randint(1, 256, (1, 32))
    first, n0 = _launches(lambda: pred.run([ids])[0])
    again, n1 = _launches(lambda: pred.run([ids])[0])
    np.testing.assert_array_equal(again, first)
    layers = cfg.num_hidden_layers
    assert n0 == n1
    assert n1["rms_norm"] == 2 * layers + 1 and n1["flash_fwd"] == layers


@pytest.mark.cuda
def test_jit_callback_on_the_card(cuda):
    """Device values reach ``fn`` as numpy once their copy completed (the
    next record or export polls; nothing synchronizes), and a call inside
    a CUDA-graph capture raises instead of recording nothing."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.framework.graphs import capture_stream
    seen = []
    x = torch.arange(8, dtype=torch.float32, device=cuda)
    obs.jit_callback(lambda a, b: seen.append((a.copy(), b.copy())),
                     x * 2, x.sum())
    torch.cuda.synchronize()
    obs.maybe_export()
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0][0], (x * 2).cpu().numpy())
    assert float(seen[0][1]) == 28.0
    g = torch.cuda.CUDAGraph()
    y = torch.zeros(8, device=cuda)
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(g, stream=capture_stream(cuda)):
            y.add_(1.0)
            obs.jit_callback(lambda a: seen.append(a), y)
    assert len(seen) == 1
