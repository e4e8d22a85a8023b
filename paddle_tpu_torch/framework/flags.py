"""Typed flag registry (counterpart of ``paddle_tpu/framework/flags.py``):
``set_flags`` / ``get_flags`` / ``flag_value``, each flag overridable by
the environment variable ``FLAGS_<name>``. Only the flags the ported
training and serving paths read are defined, with the reference's
defaults and help text. A flag's ``on_change`` hook runs on every
``set_flags`` of it and at definition when the environment sets it
(``fault_injection`` arms ``framework.faults`` that way).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    on_change: Optional[Callable[[Any], None]] = None
    value: Any = None


_REGISTRY: Dict[str, _Flag] = {}


def _coerce(ty, raw):
    if ty is bool and isinstance(raw, str):
        return raw.lower() in ("1", "true", "yes", "on")
    return ty(raw)


def define_flag(name, default, help_="", on_change=None):
    ty = type(default)
    raw = os.environ.get(f"FLAGS_{name}")
    value = _coerce(ty, raw) if raw is not None else default
    _REGISTRY[name] = _Flag(name, default, ty, help_, on_change, value)
    if on_change is not None and raw is not None:
        on_change(value)


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        k = k.removeprefix("FLAGS_")
        if k not in _REGISTRY:
            raise ValueError(f"unknown flag {k!r}")
        f = _REGISTRY[k]
        f.value = _coerce(f.type, v)
        if f.on_change is not None:
            f.on_change(f.value)


def get_flags(flags) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        k2 = k.removeprefix("FLAGS_")
        if k2 not in _REGISTRY:
            raise ValueError(f"unknown flag {k!r}")
        out[k] = _REGISTRY[k2].value
    return out


def flag_value(name: str):
    return _REGISTRY[name].value


define_flag("fused_optimizer", True,
            "Run SGD / Momentum / Adam / AdamW steps (eager step() and "
            "TrainStep) as one fused multi-tensor update per step where the "
            "configuration allows it; False forces the per-parameter path.")
define_flag("anomaly_guard", True,
            "Trainer anomaly guard: a NaN/Inf loss leaves parameters, master "
            "weights and moments at their pre-step values (device selects, "
            "no host sync), the step is never checkpointed, and training "
            "aborts after FLAGS_max_anomalous_steps consecutive bad steps.")
define_flag("max_anomalous_steps", 10,
            "Abort training with AnomalousTrainingError after this many "
            "consecutive anomalous (NaN/Inf or loss-spike) steps.")
define_flag("loss_spike_factor", 10.0,
            "A loss above this multiple of the rolling mean of recent good "
            "losses counts as anomalous; 0 disables spike detection.")


def _arm_faults(v):
    from . import faults
    faults.arm(v)


define_flag("fault_injection", "",
            "Deterministic fault-injection spec (docs/ROBUSTNESS.md): "
            "comma-separated 'site[:key=val|mode]...' entries, e.g. "
            "'ckpt_save:step=3:err,nan_loss:step=5'. Empty disarms. "
            "Sites: ckpt_save, ckpt_write, ckpt_slow, nan_loss, "
            "slow_step, rank_hang, sigterm, decode_wedge, serve_flood, "
            "collective_stall, heartbeat_stall.",
            on_change=_arm_faults)
define_flag("serve_prefill_chunk_tokens", 0,
            "ContinuousBatchingPredictor chunked prefill: prompts "
            "longer than this many tokens are ingested as page-aligned "
            "chunks interleaved with decode ticks (one mixed "
            "prefill+decode program per tick) instead of one "
            "monolithic prefill that stalls every in-flight decode. "
            "Rounded DOWN to a power-of-two multiple of page_size (a "
            "latency bound; min one page); the per-tick chunk shrinks "
            "under decode load. 0 disables (constructor "
            "prefill_chunk_tokens overrides).")
define_flag("serve_spec_draft_tokens", 0,
            "Speculative decoding: up to this many prompt-lookup "
            "drafted tokens are verified per compiled decode step "
            "(the verify span is draft_tokens + 1 wide; greedy output "
            "is bitwise-identical to plain greedy decode, sampled "
            "output rejection-sampling-correct). 0 disables "
            "(constructor spec_draft_tokens overrides; "
            "docs/SERVING.md 'Speculative decoding & sampling').")
define_flag("serve_spec_ngram_max", 3,
            "Prompt-lookup drafting: longest suffix n-gram matched "
            "against the request's own prompt+generation history when "
            "proposing draft tokens (host-side, no second model).")
define_flag("serve_sampling", False,
            "Serve-loop on-device sampling: compile the decode step "
            "with per-request temperature/top-k/top-p/seed as batched "
            "operands (requests without SamplingParams stay greedy — "
            "temperature 0 reduces to the argmax bitwise). Off keeps "
            "the plain argmax decode program.")
define_flag("serve_decode_watchdog_s", 0.0,
            "ContinuousBatchingPredictor decode watchdog: if a decode "
            "step's host sync does not resolve within this many "
            "seconds, pending requests fail with last_status "
            "'watchdog' instead of generate() hanging. 0 disables "
            "(the resolve blocks unconditionally, no polling).")
define_flag("serve_tp_degree", 1,
            "Tensor-parallel serving degree of each "
            "ContinuousBatchingPredictor replica (RuntimeConfig."
            "tp_degree). Joins the AOT bundle topology fingerprint (a "
            "mismatch invalidates with reason 'topology'). The port "
            "serves on one device: any value but 1 raises.")
define_flag("serve_role", "unified",
            "Disaggregated serving role of this replica: 'unified' "
            "(prefill+decode, the default), 'prefill' (fills KV pages "
            "and hands off at first token), or 'decode' (resumes from "
            "an imported KV page span). Joins the AOT bundle fingerprint "
            "next to topology (mismatch invalidates with reason 'role'); "
            "per-role RuntimeConfig overlays apply via "
            "RuntimeConfig.for_role.")
define_flag("quantized_grad_comm", False,
            "int8 gradient collectives with per-bucket scales and an "
            "error-feedback residual (RuntimeConfig.quantized_grad_comm; "
            "carried for the distributed trainer, unread on one device).")
define_flag("grad_bucket_bytes", 32 * 1024 * 1024,
            "Target flat-bucket payload size for gradient collectives "
            "(RuntimeConfig.grad_bucket_bytes; carried for the "
            "distributed trainer, unread on one device).")
define_flag("shm_channel_capacity_mb", 64,
            "Per-DataLoader shared-memory ring capacity (native worker pool).")
