"""Typed flag registry (counterpart of ``paddle_tpu/framework/flags.py``):
``set_flags`` / ``get_flags`` / ``flag_value``, each flag overridable by
the environment variable ``FLAGS_<name>``. Only the flags the ported
training path reads are defined, with the reference's defaults.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class _Flag:
    name: str
    default: Any
    type: type
    help: str
    value: Any = None


_REGISTRY: Dict[str, _Flag] = {}


def _coerce(ty, raw):
    if ty is bool and isinstance(raw, str):
        return raw.lower() in ("1", "true", "yes", "on")
    return ty(raw)


def define_flag(name, default, help_=""):
    ty = type(default)
    raw = os.environ.get(f"FLAGS_{name}")
    value = _coerce(ty, raw) if raw is not None else default
    _REGISTRY[name] = _Flag(name, default, ty, help_, value)


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        k = k.removeprefix("FLAGS_")
        if k not in _REGISTRY:
            raise ValueError(f"unknown flag {k!r}")
        f = _REGISTRY[k]
        f.value = _coerce(f.type, v)


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
