"""The router control loop: telemetry in, pool actions out
(counterpart of ``paddle_tpu/serving/controller.py``).

Everything below this module observes (autoscale.py computes a
reference ``desired_replicas`` nobody reads; slo.py keeps burn-rate
accounting). :class:`PoolController` is the first consumer that ACTS:
a tick-driven loop over ``slo.*``, ``serving.autoscale.*`` and
``fleet.*`` gauges that

- **scales out** — revives a parked replica (predictor and compiled
  programs still warm) or spawns a fresh one via the caller's factory
  when the driving SLO burns or the smoothed desired size exceeds the
  pool;
- **scales in** — drains the least-loaded replica after a sustained
  quiet period and parks it for later revival;
- **shifts WFS quanta** — a per-tenant SLO burning while the pool as a
  whole is fine means the tenant is losing the fairness race, so its
  tier weight is raised on every LIVE scheduler
  (Router.set_tier_weight), and restored once the burn clears;
- **sheds at the admission edge** — when the fast window burns past
  ``shed_burn`` the budget is going regardless; refusing the
  lowest-weight tier up front (Router.set_shed_tiers) is cheaper than
  admitting work that will breach anyway.

Every decision is one evidence-carrying ``{"kind": "control"}`` JSONL
record — rule fired, action, parameters, the input snapshot it was
decided on, and the cooldown it armed — so the autopilot is auditable
(and replayable: tools/trace_replay.py rebuild_timeline reconstructs
the pool state from the records alone; the bench acceptance test
asserts the reconstruction matches reality). Flap damping is explicit:
per-rule cooldowns, the autoscale demand EWMA (the same half-life the
SLO fast window uses), and a consecutive-quiet-ticks gate on scale-in.

The SLO engine and burn accounting are ``observability.slo``; the
reference's docs/OBSERVABILITY.md "SLOs & the control loop" describes
the rules.
"""
from __future__ import annotations

import inspect
import time
from typing import Callable, Dict, List, Optional

from ..observability import metrics as _obsm
from ..observability.runtime import export_record
from ..observability.slo import Ewma, SLOEngine
from .autoscale import autoscale_signals, publish_autoscale

__all__ = ["ControllerConfig", "PoolController"]


class ControllerConfig:
    """Knobs for the control loop. Burn thresholds are in burn-rate
    units (1.0 = spending the error budget exactly at the tolerated
    rate); cooldowns in seconds on the controller's clock."""

    def __init__(self, slo_name: str = "ttft",
                 scale_out_burn: float = 1.0,
                 scale_in_burn: float = 0.5,
                 shed_burn: float = 2.0,
                 shed_recover_burn: float = 1.0,
                 scale_out_cooldown_s: float = 3.0,
                 scale_in_cooldown_s: float = 15.0,
                 shift_cooldown_s: float = 5.0,
                 scale_in_quiet_ticks: int = 3,
                 max_replicas: int = 8,
                 weight_shift_factor: float = 2.0,
                 max_weight_factor: float = 8.0):
        self.slo_name = slo_name
        self.scale_out_burn = float(scale_out_burn)
        self.scale_in_burn = float(scale_in_burn)
        self.shed_burn = float(shed_burn)
        self.shed_recover_burn = float(shed_recover_burn)
        self.scale_out_cooldown_s = float(scale_out_cooldown_s)
        self.scale_in_cooldown_s = float(scale_in_cooldown_s)
        self.shift_cooldown_s = float(shift_cooldown_s)
        self.scale_in_quiet_ticks = int(scale_in_quiet_ticks)
        self.max_replicas = int(max_replicas)
        self.weight_shift_factor = float(weight_shift_factor)
        self.max_weight_factor = float(max_weight_factor)


class PoolController:
    """Tick-driven pool autopilot over one Router.

    `spawn` is the scale-out factory: a zero-arg callable returning a
    ready predictor (or None when capacity is exhausted). Without it
    the controller can still revive replicas it drained itself.
    `now_fn` is injectable so tests (and the replay bench) drive a
    synthetic clock; nothing here touches a device.
    """

    def __init__(self, router, slo_engine: Optional[SLOEngine] = None,
                 spawn: Optional[Callable[[], object]] = None,
                 config: Optional[ControllerConfig] = None,
                 slo_ttft_s: float = 0.25,
                 registry: Optional[object] = None,
                 now_fn=time.time):
        self.router = router
        self.cfg = config or ControllerConfig()
        self.engine = slo_engine if slo_engine is not None else SLOEngine()
        self.spawn = spawn
        # role-aware spawn: a factory that declares a parameter gets the
        # role it is spawning FOR (disaggregated fleets build different
        # per-role configs/bundles); a zero-arg legacy factory is called
        # as before. Decided once here, not per call — a TypeError from
        # inside the factory must not silently flip the calling style.
        try:
            self._spawn_takes_role = spawn is not None and \
                len(inspect.signature(spawn).parameters) >= 1
        except (TypeError, ValueError):
            self._spawn_takes_role = False
        self.slo_ttft_s = float(slo_ttft_s)
        self._now = now_fn
        self._reg = registry if registry is not None \
            else _obsm.get_registry()
        self._m_actions = self._reg.counter("serving.controller.actions")
        self._m_ticks = self._reg.counter("serving.controller.ticks")
        self._m_pool = self._reg.gauge("serving.controller.pool_size")
        self._cooldown_until: Dict[str, float] = {}
        # demand smoothing on the SLO fast-window half-life: the
        # controller and the burn accounting damp on the same clock
        self._demand_ewma = Ewma(
            half_life_s=self.engine.fast_window_s / 4.0)
        self._quiet_ticks = 0
        self._quiet_ticks_role: Dict[str, int] = {}
        self._parked: List[object] = []    # drained Replicas, warm
        self._base_weights = dict(router.tier_weights or {})
        self._seq = 0
        self._tick_no = 0
        self.decisions: List[dict] = []    # in-memory audit mirror
        self._record("init", "observe", inputs=self._inputs({}, {}),
                     params={"pool": self._pool_size(),
                             "tier_weights": dict(
                                 router.tier_weights or {}),
                             "shed_tiers": sorted(router.shed_tiers)})

    # ---------------------------------------------------------- helpers --
    def _pool_size(self, role: Optional[str] = None) -> int:
        if role is None:
            return len(self.router.healthy())
        return sum(1 for r in self.router.healthy()
                   if getattr(r, "role", "unified") == role)

    def _grow(self, role: Optional[str] = None):
        """Revive the most recently parked replica (matching `role` when
        given — a parked prefill replica's compiled programs are useless
        to the decode fleet) or spawn a fresh one via the factory.
        Returns ``(how, replica)``, or ``(None, None)`` when neither
        lever is available."""
        for i in range(len(self._parked) - 1, -1, -1):
            rep = self._parked[i]
            if role is None or getattr(rep, "role", "unified") == role:
                del self._parked[i]
                rep.revive()
                return "revive", rep
        if self.spawn is None:
            return None, None
        pred = self.spawn(role) if self._spawn_takes_role \
            else self.spawn()
        if pred is None:
            return None, None
        if role is None:
            # keyword-free call: duck-typed routers (and the test
            # stubs) predate the role parameter
            return "spawn", self.router.add_replica(pred)
        return "spawn", self.router.add_replica(pred, role=role)

    def _cooling(self, rule: str, now: float) -> bool:
        return now < self._cooldown_until.get(rule, 0.0)

    def _arm(self, rule: str, now: float, seconds: float):
        self._cooldown_until[rule] = now + seconds

    def _inputs(self, slo: dict, sig: dict) -> dict:
        """The decision-input snapshot stamped on every record: the
        driving SLO's burn, the autoscale view, and the fleet gauges
        when a training fleet shares the telemetry stream."""
        drv = slo.get(self.cfg.slo_name, {})
        burn = drv.get("burn", {})
        inp = {"slo": self.cfg.slo_name,
               "burn_fast": round(burn.get("fast", 0.0), 4),
               "burn_slow": round(burn.get("slow", 0.0), 4),
               "tier_burn_fast": {
                   name: round(st["burn"]["fast"], 4)
                   for name, st in slo.items()
                   if st.get("tier") is not None},
               "healthy": sig.get("healthy_replicas"),
               "desired": sig.get("desired_replicas"),
               "demand_raw": sig.get("demand_raw"),
               "demand": sig.get("demand"),
               "queue_depth": sig.get("queue_depth")}
        if sig.get("roles"):
            inp["roles"] = {role: {"healthy": rs.get("healthy"),
                                   "desired": rs.get("desired"),
                                   "demand": rs.get("demand")}
                            for role, rs in sig["roles"].items()}
        for g in ("fleet.step_time_seconds", "fleet.comm_wait_share",
                  "fleet.heartbeat_gap_seconds"):
            m = self._reg.get(g)
            if m is not None:
                vals = [s.value for s in m.samples()]
                if vals:
                    inp[g] = round(max(vals), 4)
        return inp

    def _record(self, rule: str, action: str, inputs: dict,
                params: dict, cooldown_s: float = 0.0,
                tier: Optional[str] = None):
        self._seq += 1
        rec = {"kind": "control", "ts": round(time.time(), 6),
               "seq": self._seq, "tick": self._tick_no, "rule": rule,
               "action": action, "params": params, "inputs": inputs,
               "cooldown_s": cooldown_s}
        if tier is not None:
            rec["tier"] = tier
        export_record(rec)
        self.decisions.append(rec)
        tl = {"tier": tier} if tier else {}
        self._m_actions.inc(rule=rule, action=action, **tl)
        return rec

    # ------------------------------------------------------------- tick --
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One control cycle: evaluate SLOs, publish autoscale signals,
        fire at most one pool action plus the independent shed/quantum
        levers. Returns the decision records made this tick."""
        t = self._now() if now is None else float(now)
        self._tick_no += 1
        self._m_ticks.inc()
        slo = self.engine.evaluate(now=t)
        sig = autoscale_signals(self.router, slo_ttft_s=self.slo_ttft_s,
                                smoother=self._demand_ewma)
        publish_autoscale(sig)
        inputs = self._inputs(slo, sig)
        made: List[dict] = []
        made += self._rule_shed(slo, inputs, t)
        made += self._rule_shift(slo, inputs, t)
        pool = self._rule_scale_out(slo, sig, inputs, t) \
            or self._rule_scale_in(slo, sig, inputs, t)
        made += pool
        self._m_pool.set(self._pool_size())
        return made

    # ------------------------------------------------------------ rules --
    def _burn(self, slo: dict, window: str) -> float:
        return slo.get(self.cfg.slo_name, {}) \
            .get("burn", {}).get(window, 0.0)

    def _rule_scale_out(self, slo, sig, inputs, now) -> List[dict]:
        roles = sig.get("roles")
        if roles:
            return self._rule_scale_out_role(slo, roles, inputs, now)
        healthy = self._pool_size()
        desired = int(sig.get("desired_replicas") or healthy)
        burning = self._burn(slo, "fast") >= self.cfg.scale_out_burn
        if healthy >= self.cfg.max_replicas \
                or (desired <= healthy and not burning) \
                or self._cooling("scale_out", now):
            return []
        how, rep = self._grow()
        if rep is None:
            return []
        self._arm("scale_out", now, self.cfg.scale_out_cooldown_s)
        self._quiet_ticks = 0
        return [self._record(
            "scale_out", how, inputs,
            params={"replica": rep.name, "pool_before": healthy,
                    "pool_after": self._pool_size()},
            cooldown_s=self.cfg.scale_out_cooldown_s)]

    def _rule_scale_out_role(self, slo, roles, inputs, now
                             ) -> List[dict]:
        """Disaggregated scale-out: each role's fleet is sized from its
        own autoscale block so a prefill spike grows the prefill fleet,
        not N copies of everything. Most-starved role first; still at
        most one pool action per tick; cooldowns are keyed per
        (rule, role) so growing one fleet never blocks the other."""
        if self._pool_size() >= self.cfg.max_replicas:
            return []
        burning = self._burn(slo, "fast") >= self.cfg.scale_out_burn
        order = sorted(roles.items(), reverse=True,
                       key=lambda kv: (kv[1].get("desired", 0)
                                       - kv[1].get("healthy", 0)))
        for role, rs in order:
            healthy_r = self._pool_size(role)
            desired_r = int(rs.get("desired") or healthy_r)
            if (desired_r <= healthy_r and not burning) \
                    or self._cooling(f"scale_out:{role}", now):
                continue
            how, rep = self._grow(role)
            if rep is None:
                continue
            self._arm(f"scale_out:{role}", now,
                      self.cfg.scale_out_cooldown_s)
            self._quiet_ticks_role[role] = 0
            return [self._record(
                "scale_out", how, inputs,
                params={"replica": rep.name, "role": role,
                        "pool_before": healthy_r,
                        "pool_after": self._pool_size(role)},
                cooldown_s=self.cfg.scale_out_cooldown_s)]
        return []

    def _rule_scale_in(self, slo, sig, inputs, now) -> List[dict]:
        roles = sig.get("roles")
        if roles:
            return self._rule_scale_in_role(slo, roles, inputs, now)
        healthy = self._pool_size()
        desired = int(sig.get("desired_replicas") or healthy)
        quiet = desired < healthy \
            and self._burn(slo, "fast") <= self.cfg.scale_in_burn
        self._quiet_ticks = self._quiet_ticks + 1 if quiet else 0
        if not quiet or healthy <= 1 \
                or self._quiet_ticks < self.cfg.scale_in_quiet_ticks \
                or self._cooling("scale_in", now):
            return []
        rep = self.router.drain_replica()
        if rep is None:
            return []
        self._parked.append(rep)
        self._arm("scale_in", now, self.cfg.scale_in_cooldown_s)
        self._quiet_ticks = 0
        return [self._record(
            "scale_in", "drain", inputs,
            params={"replica": rep.name, "pool_before": healthy,
                    "pool_after": self._pool_size(), "parked": True},
            cooldown_s=self.cfg.scale_in_cooldown_s)]

    def _rule_scale_in_role(self, slo, roles, inputs, now) -> List[dict]:
        """Disaggregated scale-in: per-role quiet-tick counters (a calm
        decode fleet can shrink while prefill is still hot), drain via
        the role-scoped selector (which refuses the last replica of a
        role — a disaggregated pool must keep both stages alive). All
        counters advance every tick before any action fires."""
        calm = self._burn(slo, "fast") <= self.cfg.scale_in_burn
        eligible: List[str] = []
        for role, rs in sorted(roles.items()):
            healthy_r = self._pool_size(role)
            desired_r = int(rs.get("desired") or healthy_r)
            quiet = calm and desired_r < healthy_r
            q = self._quiet_ticks_role.get(role, 0) + 1 if quiet else 0
            self._quiet_ticks_role[role] = q
            if quiet and healthy_r > 1 \
                    and q >= self.cfg.scale_in_quiet_ticks \
                    and not self._cooling(f"scale_in:{role}", now):
                eligible.append(role)
        for role in eligible:
            healthy_r = self._pool_size(role)
            rep = self.router.drain_replica(role=role)
            if rep is None:
                continue
            self._parked.append(rep)
            self._arm(f"scale_in:{role}", now,
                      self.cfg.scale_in_cooldown_s)
            self._quiet_ticks_role[role] = 0
            return [self._record(
                "scale_in", "drain", inputs,
                params={"replica": rep.name, "role": role,
                        "pool_before": healthy_r,
                        "pool_after": self._pool_size(role),
                        "parked": True},
                cooldown_s=self.cfg.scale_in_cooldown_s)]
        return []

    def _rule_shift(self, slo, inputs, now) -> List[dict]:
        """Per-tenant fairness lever: a tier-scoped SLO burning means
        that tenant is starved of quanta — raise its live weight; once
        no tier-scoped SLO burns, restore the declared weights."""
        if self.router.tier_weights is None \
                or self._cooling("shift_quantum", now):
            return []
        burning = [st for st in slo.values()
                   if st.get("tier") is not None
                   and st["burn"]["fast"] >= self.cfg.scale_out_burn]
        made: List[dict] = []
        if burning:
            st = max(burning, key=lambda s: s["burn"]["fast"])
            tier = st["tier"]
            base = self._base_weights.get(tier, 1.0)
            cur = self.router.tier_weights.get(tier, base)
            new = min(cur * self.cfg.weight_shift_factor,
                      base * self.cfg.max_weight_factor)
            if new > cur:
                self.router.set_tier_weight(tier, new)
                self._arm("shift_quantum", now,
                          self.cfg.shift_cooldown_s)
                made.append(self._record(
                    "shift_quantum", "raise_weight", inputs,
                    params={"weight_before": cur, "weight_after": new,
                            "base_weight": base, "slo": st["slo"]},
                    cooldown_s=self.cfg.shift_cooldown_s, tier=tier))
        else:
            for tier, base in self._base_weights.items():
                cur = self.router.tier_weights.get(tier, base)
                if cur != base:
                    self.router.set_tier_weight(tier, base)
                    made.append(self._record(
                        "shift_quantum", "restore_weight", inputs,
                        params={"weight_before": cur,
                                "weight_after": base},
                        cooldown_s=0.0, tier=tier))
        return made

    def _rule_shed(self, slo, inputs, now) -> List[dict]:
        """Admission-edge load shed: past `shed_burn` the budget is
        gone either way — refuse the lowest-weight tier up front and
        re-admit it once the fast window recovers."""
        burn = self._burn(slo, "fast")
        shedding = bool(self.router.shed_tiers)
        if not shedding and burn >= self.cfg.shed_burn:
            victim = self._lowest_tier()
            if victim is None:
                return []
            self.router.set_shed_tiers({victim})
            return [self._record(
                "shed", "shed_on", inputs,
                params={"shed_tiers": [victim], "burn": round(burn, 4)},
                tier=victim)]
        if shedding and burn < self.cfg.shed_recover_burn:
            was = sorted(self.router.shed_tiers)
            self.router.set_shed_tiers(())
            return [self._record(
                "shed", "shed_off", inputs,
                params={"shed_tiers_before": was,
                        "burn": round(burn, 4)})]
        return []

    def _lowest_tier(self) -> Optional[str]:
        """The shed victim: the lowest-weight declared tier that no
        tier-scoped SLO protects."""
        weights = self.router.tier_weights
        if not weights:
            return None
        protected = {s.tier for s in self.engine.specs
                     if s.tier is not None}
        cands = [(w, t) for t, w in weights.items()
                 if t not in protected]
        if not cands:
            return None
        return min(cands)[1]

    # ------------------------------------------------------ convenience --
    def park_count(self) -> int:
        return len(self._parked)
