"""Deterministic, seeded fault injection (counterpart of
``paddle_tpu/framework/faults.py``).

A process-wide registry of *fault sites*: named points in the runtime
that ask ``faults.check("site", step=...)`` whether an armed fault
fires there. Unarmed, a check is one attribute load and a ``None``
return.

Faults are armed with spec strings, via ``FLAGS_fault_injection``
(environment or ``framework.flags.set_flags``) or with :func:`arm`::

    decode_wedge:sleep=5,serve_flood:n=100

Grammar (comma-separated specs; each spec is colon-separated tokens)::

    site[:key=value | mode]...

Match keys
    ``step=N`` / ``step=A-B``  match the ``step`` kwarg the site passes
    ``hit=N``                  fire on the Nth check of this site (1-based)
    ``every=N``                fire on every Nth check
    ``times=K``                max fires for this spec (0 = unlimited;
                               default 1, or 0 when ``every``/``prob``
                               is given: those describe recurring
                               faults)
    ``prob=P`` [``seed=S``]    fire with probability P, deterministically:
                               the coin is a hash of (seed, site, hit
                               count), so a spec fires at the same hits
                               in every run
Action modes (bare words; sites interpret them)
    ``err``, ``truncate``, ``corrupt``, ``drop_manifest``, ``nan``,
    ``inf``, ``sigterm``, ``drop``
    ``sleep=S``   stall the site for S seconds (a wedged decode)
    ``flood``     serving: inflate the apparent queue depth by ``n=K``

The port's sites: ``serve_flood`` and ``decode_wedge`` (in
``inference.ContinuousBatchingPredictor``). The spec grammar, the
default mode of each site, the hit counting and the ``prob`` coin are
the reference's, so one spec fires at the same checks in both. Every
fired fault is recorded in :func:`events` and counted in the
``robustness.faults_injected`` series (by site and mode) of
``observability``.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["FaultSpec", "FaultAction", "FaultRegistry", "arm", "disarm",
           "check", "armed", "events", "get_registry"]

_MODES = ("err", "truncate", "corrupt", "drop_manifest", "nan", "inf",
          "sigterm", "sleep", "flood", "drop")

# a bare site with no explicit mode gets its natural failure kind
_DEFAULT_MODES = {
    "ckpt_save": "err", "ckpt_write": "truncate", "nan_loss": "nan",
    "slow_step": "sleep", "sigterm": "sigterm", "decode_wedge": "sleep",
    "serve_flood": "flood", "rank_hang": "sleep", "slow_rank": "sleep",
    "collective_stall": "sleep", "ckpt_slow": "sleep",
    "heartbeat_stall": "sleep", "rank_slow": "sleep",
    "comm_degraded": "sleep", "handoff_corrupt": "corrupt",
}


@dataclass
class FaultSpec:
    """One parsed fault spec: where it fires, when, and what it does."""
    site: str
    mode: str
    step_lo: Optional[int] = None
    step_hi: Optional[int] = None
    hit: Optional[int] = None
    every: Optional[int] = None
    times: int = 1              # 0 = unlimited
    prob: Optional[float] = None
    seed: int = 0
    params: Dict[str, float] = field(default_factory=dict)
    fired: int = 0
    text: str = ""

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        toks = [t for t in text.strip().split(":") if t]
        if not toks:
            raise ValueError(f"empty fault spec in {text!r}")
        spec = cls(site=toks[0], mode="", text=text.strip())
        times_explicit = False
        for tok in toks[1:]:
            if "=" in tok:
                k, v = tok.split("=", 1)
                if k == "step":
                    if "-" in v:
                        lo, hi = v.split("-", 1)
                        spec.step_lo, spec.step_hi = int(lo), int(hi)
                    else:
                        spec.step_lo = spec.step_hi = int(v)
                elif k == "hit":
                    spec.hit = int(v)
                elif k == "every":
                    spec.every = int(v)
                elif k == "times":
                    spec.times = int(v)
                    times_explicit = True
                elif k == "prob":
                    spec.prob = float(v)
                elif k == "seed":
                    spec.seed = int(v)
                elif k == "sleep":
                    spec.mode = "sleep"
                    spec.params["sleep"] = float(v)
                else:
                    spec.params[k] = float(v)
            elif tok in _MODES:
                spec.mode = tok
            else:
                raise ValueError(
                    f"unknown token {tok!r} in fault spec {text!r} "
                    f"(modes: {', '.join(_MODES)})")
        if not spec.mode:
            spec.mode = _DEFAULT_MODES.get(spec.site, "err")
        if not times_explicit and (spec.every is not None
                                   or spec.prob is not None):
            spec.times = 0  # every=/prob= describe RECURRING faults
        return spec

    def _coin(self, hit_count: int) -> bool:
        """Deterministic Bernoulli draw keyed by (seed, site, hit)."""
        h = hashlib.sha256(
            f"{self.seed}:{self.site}:{hit_count}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < self.prob

    def matches(self, step: Optional[int], hit_count: int) -> bool:
        if self.times and self.fired >= self.times:
            return False
        if self.step_lo is not None:
            if step is None or not (self.step_lo <= step <= self.step_hi):
                return False
        if self.hit is not None and hit_count != self.hit:
            return False
        if self.every is not None and hit_count % self.every != 0:
            return False
        if self.prob is not None and not self._coin(hit_count):
            return False
        return True


@dataclass
class FaultAction:
    """What a site should do: returned by check() when a spec fires."""
    site: str
    mode: str
    params: Dict[str, float]
    spec: FaultSpec


class FaultRegistry:
    """Process-wide armed-fault state. One instance (module-level); the
    ``FLAGS_fault_injection`` on_change hook keeps it in sync with the
    flag, so arming through the environment works before any subsystem
    imports."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: List[FaultSpec] = []
        self._hits: Dict[str, int] = {}
        self._events: List[dict] = []

    def arm(self, spec_text: Optional[str]):
        """Replace the armed spec set (empty/None disarms). Hit and
        fired counts reset so arming is a clean experiment boundary."""
        specs = []
        for part in (spec_text or "").split(","):
            part = part.strip()
            if part:
                specs.append(FaultSpec.parse(part))
        with self._lock:
            self._specs = specs
            self._hits = {}
            self._events = []

    def disarm(self):
        self.arm(None)

    @property
    def armed(self) -> bool:
        return bool(self._specs)

    def check(self, site: str, step: Optional[int] = None) \
            -> Optional[FaultAction]:
        """Ask whether an armed fault fires at this site now. Counts
        the check (hit) even when nothing fires, so hit-based specs are
        deterministic; near-zero cost while disarmed."""
        if not self._specs:          # fast path: nothing armed
            return None
        with self._lock:
            h = self._hits.get(site, 0) + 1
            self._hits[site] = h
            for spec in self._specs:
                if spec.site != site or not spec.matches(step, h):
                    continue
                spec.fired += 1
                act = FaultAction(site=site, mode=spec.mode,
                                  params=dict(spec.params), spec=spec)
                self._events.append({"site": site, "mode": spec.mode,
                                     "step": step, "hit": h,
                                     "spec": spec.text})
                break
            else:
                return None
        # record outside the lock: the metrics layer has its own
        from ..observability import metrics as _obsm
        _obsm.counter("robustness.faults_injected").inc(
            site=site, mode=act.mode)
        return act

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)


_registry = FaultRegistry()


def get_registry() -> FaultRegistry:
    return _registry


def arm(spec_text: Optional[str]):
    _registry.arm(spec_text)


def disarm():
    _registry.disarm()


def armed() -> bool:
    return _registry.armed


def check(site: str, step: Optional[int] = None) -> Optional[FaultAction]:
    return _registry.check(site, step=step)


def events() -> List[dict]:
    return _registry.events()
