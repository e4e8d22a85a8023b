"""The port's whole ``RuntimeConfig`` against the JAX reference's.

Every field, default and check is the reference's, so one configuration
gives the same ``to_dict()`` and ``config_hash()`` in both packages, the
per-role overlays (``for_role``) agree, ``from_flags`` reads the same
flags, a bundle's ``runtime_config_hash`` is the reference's, and an
``aot.config_drift`` count names the same keys. The autotune loop: each
package serves a few requests with its JSONL sink attached,
``tools/autotune.py <telemetry> --json`` analyses the file, and the
tuned ``runtime_config`` it reports loads with ``RuntimeConfig.from_dict``
and serves in both packages with equal tokens. Exact equality
throughout (dicts, hash strings, tokens).
"""
import json
import subprocess
import sys

import pytest

import paddle_tpu as paddle
import paddle_tpu.observability as ref_obs
from paddle_tpu.framework import runtime_config as ref_rc
from paddle_tpu.inference import ContinuousBatchingPredictor as RefPredictor

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework import runtime_config as port_rc
from paddle_tpu_torch.framework.runtime_config import RuntimeConfig
from paddle_tpu_torch.inference import ContinuousBatchingPredictor, aot

from test_torch_predictor import GEOM, REPO, _pair, _prompts

# a configuration away from every default (tp_degree stays 1: the port
# serves on one device)
TUNED = dict(max_batch_size=2, page_size=8, num_pages=24, max_seq_len=64,
             prompt_buckets=(16, 8, 16), prefill_chunk_tokens=16,
             spec_draft_tokens=3, spec_ngram_max=2, sampling_enabled=True,
             serve_role="decode", max_queue=7, shed_policy="oldest",
             decode_watchdog_s=1.5, wfs_quantum=32.0,
             grad_bucket_bytes=1 << 20, quantized_grad_comm=True,
             zero_stage=2)

FLAG_VALUES = {"serve_prefill_chunk_tokens": 32,
               "serve_decode_watchdog_s": 2.5,
               "serve_spec_draft_tokens": 2, "serve_spec_ngram_max": 4,
               "serve_sampling": True, "serve_tp_degree": 1,
               "grad_bucket_bytes": 1 << 22, "quantized_grad_comm": True,
               "serve_role": "prefill"}


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, ref_obs):
        o.configure(None)
        o.enabled(True)
        o.get_registry().reset()
    yield
    defaults = {k: flags._REGISTRY[k].default for k in FLAG_VALUES}
    paddle.set_flags(defaults)
    flags.set_flags(defaults)
    for o in (obs, ref_obs):
        o.configure(None)
        o.get_registry().reset()


@pytest.mark.parametrize("kw", [{}, TUNED], ids=["default", "tuned"])
def test_dict_and_hash_equal_the_reference(kw):
    port, ref = RuntimeConfig(**kw), ref_rc.RuntimeConfig(**kw)
    assert list(port.to_dict()) == list(ref.to_dict())     # field order
    assert port.to_dict() == ref.to_dict()
    assert port.config_hash() == ref.config_hash()
    assert port_rc.config_hash(port.to_dict()) == \
        ref_rc.config_hash(ref.to_dict())
    assert RuntimeConfig.from_dict(ref.to_dict()) == port
    assert port_rc.MIGRATED_FLAG_KNOBS == ref_rc.MIGRATED_FLAG_KNOBS
    assert port_rc.ROLE_OVERLAYS == ref_rc.ROLE_OVERLAYS
    assert port_rc.SERVE_ROLES == ref_rc.SERVE_ROLES
    assert port_rc.COMPILED_FIELDS == ref_rc.COMPILED_FIELDS


@pytest.mark.parametrize("role", ["unified", "prefill", "decode"])
def test_for_role_equal_the_reference(role):
    base = dict(TUNED, serve_role="unified")
    port = RuntimeConfig(**base).for_role(role, max_queue=3)
    ref = ref_rc.RuntimeConfig(**base).for_role(role, max_queue=3)
    assert port.to_dict() == ref.to_dict()
    assert port.config_hash() == ref.config_hash()
    with pytest.raises(ValueError, match="serve_role"):
        RuntimeConfig().for_role("bogus")


def test_validation_equal_the_reference():
    """The reference's checks raise here too; a tensor-parallel degree
    other than 1 is refused by the port alone (one device)."""
    for bad in (dict(zero_stage=4), dict(serve_role="bogus"),
                dict(shed_policy="lifo"), dict(page_size=0),
                dict(spec_draft_tokens=-1), dict(version=2)):
        with pytest.raises(ValueError):
            ref_rc.RuntimeConfig(**bad)
        with pytest.raises(ValueError):
            RuntimeConfig(**bad)
    with pytest.raises(ValueError, match="tp_degree"):
        RuntimeConfig(tp_degree=2)
    with pytest.raises(ValueError, match="unknown"):
        RuntimeConfig.from_dict({**RuntimeConfig().to_dict(), "bogus": 1})


def test_from_flags_equal_the_reference():
    assert RuntimeConfig.from_flags().to_dict() == \
        ref_rc.RuntimeConfig.from_flags().to_dict()
    paddle.set_flags(FLAG_VALUES)
    flags.set_flags(FLAG_VALUES)
    port, ref = RuntimeConfig.from_flags(), ref_rc.RuntimeConfig.from_flags()
    assert port.to_dict() == ref.to_dict()
    for flag, field in port_rc.MIGRATED_FLAG_KNOBS.items():
        assert getattr(port, field) == FLAG_VALUES[flag]


def _serve_with_sink(o, predictor, path, prompts):
    o.configure(str(path))
    try:
        out = predictor.generate(prompts, max_new_tokens=4)
        o.maybe_export()
    finally:
        o.configure(None)
    return out


def _autotune(path):
    r = subprocess.run([sys.executable, str(REPO / "tools" / "autotune.py"),
                        str(path), "--json"], capture_output=True,
                       text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_autotune_report_loads_and_serves_in_both(tmp_path):
    """F2: the tuned config ``tools/autotune.py`` writes from either
    package's telemetry carries every field, the training ones too; it
    loads in the port and serves there and in the reference with equal
    tokens."""
    ref_m, port_m = _pair()
    prompts = _prompts(3, (5, 9, 13, 6, 11, 7, 12, 10))
    ref_p = RefPredictor(ref_m, **GEOM)
    port_p = ContinuousBatchingPredictor(port_m, device="cpu", **GEOM)
    want = _serve_with_sink(ref_obs, ref_p, tmp_path / "ref.jsonl", prompts)
    assert _serve_with_sink(obs, port_p, tmp_path / "port.jsonl",
                            prompts) == want
    for name in ("ref.jsonl", "port.jsonl"):
        report = _autotune(tmp_path / name)
        d = report["runtime_config"]
        assert {"grad_bucket_bytes", "quantized_grad_comm",
                "zero_stage"} <= set(d)
        rc = RuntimeConfig.from_dict(d)
        rrc = ref_rc.RuntimeConfig.from_dict(d)
        assert rc.config_hash() == rrc.config_hash() == \
            report["runtime_config_hash"]
        got = ContinuousBatchingPredictor(
            port_m, device="cpu", runtime_config=rc).generate(
                prompts[:3], max_new_tokens=4)
        assert got == RefPredictor(ref_m, runtime_config=rrc).generate(
            prompts[:3], max_new_tokens=4)


def test_bundle_config_hash_and_drift_equal_the_reference(tmp_path):
    """A bundle built from one config records, as its
    ``runtime_config_hash``, the hash the reference gives the same
    effective config; a warm start under flags that disagree with
    the bundle's config counts ``aot.config_drift`` on the same keys in
    both packages (the reference's warm start fails on this host, so its
    drift keys come from its own rule: the diff against
    ``from_flags()`` on the migrated knobs)."""
    _, port_m = _pair()
    rc = RuntimeConfig(max_batch_size=2, page_size=8, max_seq_len=64,
                       prompt_buckets=(8,))
    path = str(tmp_path / "bundle")
    man = aot.EngineBuilder(port_m, batch_sizes=[1], capture_forward=False,
                            runtime_config=rc).build(path, wire_cache=False)
    ref_eff = ref_rc.RuntimeConfig(**{**rc.to_dict(), "num_pages": None})
    ref_eff = ref_eff.replace(
        num_pages=man["runtime_config"]["num_pages"])
    assert man["runtime_config"] == ref_eff.to_dict()
    assert man["runtime_config_hash"] == ref_eff.config_hash()
    drift = {"serve_spec_ngram_max": 5, "grad_bucket_bytes": 1 << 20,
             "serve_decode_watchdog_s": 0.5}
    flags.set_flags(drift)
    paddle.set_flags(drift)
    obs.get_registry().reset()
    aot.warm_start(port_m, path, wire_cache=False, device="cpu")
    m = obs.get_registry().get("aot.config_drift")
    got = sorted(s.labels["key"] for s in m.samples() if s.value)
    eff = ref_rc.RuntimeConfig.from_dict(man["runtime_config"])
    want = sorted(set(eff.diff(ref_rc.RuntimeConfig.from_flags()))
                  & set(ref_rc.MIGRATED_FLAG_KNOBS.values()))
    assert got == want == ["decode_watchdog_s", "grad_bucket_bytes",
                           "spec_ngram_max"]
