"""Priority tiers with weighted fair queueing for the admission queue
(counterpart of ``paddle_tpu/serving/scheduler.py``).

The queue disciplines the serve loop
(``inference.ContinuousBatchingPredictor``) plugs in:

- :class:`FifoQueue`: one FIFO, the discipline whenever no tiers are
  given.
- :class:`WeightedFairScheduler`: per-tier FIFO queues served by
  **deficit round robin** (Shreedhar & Varghese): each visit to a
  non-empty tier adds ``quantum * weight`` to its deficit and the tier
  admits requests while the deficit covers their cost. A tier's
  long-run admission share converges to ``weight / sum(weights)``
  whatever the offered load, so a low-tier flood cannot starve an
  interactive tenant.

Both expose one queue interface (push / push_front / pop / consume /
remove / ids / depths / pick_shed), so the serve loop has one code path.

Shedding is priority-aware: `pick_shed` removes from the lowest-weight
tier whose depth exceeds its weight share of ``max_queue``. When the
queue is over capacity at least one tier exceeds its share (the shares
sum to ``max_queue``), so a tier within its share is never shed. Within
a tier the ``newest|oldest`` policy applies. Deadline-expired entries
are the serve loop's to evict, before any shed decision.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

__all__ = ["FifoQueue", "WeightedFairScheduler", "DEFAULT_TIER",
           "stage_cost"]

DEFAULT_TIER = "default"


def stage_cost(prompt_len: int, max_new: int, stage: Optional[str]
               ) -> float:
    """The cost estimate of one request at one dispatch stage, the
    reference's: a unified dispatch (`stage` None) weighs
    ``prompt_len + max_new``; under disaggregated two-stage dispatch the
    prefill stage carries the prompt ingest plus its first token, and
    the decode stage the remaining token budget plus a page-order term
    for the imported span it attends over. The port's serve loop pushes
    the unified cost; the staged forms wait for disaggregated roles."""
    if stage == "prefill":
        return float(prompt_len + 1)
    if stage == "decode":
        # the span import is cheap next to decoding, but a decode
        # replica still pays attention bandwidth over the prompt's
        # pages every tick — keep a fractional prompt term so a
        # long-context decode is not booked as free
        return float(max_new + prompt_len / 8.0)
    return float(prompt_len + max_new)


class FifoQueue:
    """Single-FIFO queue discipline (the no-tiers case).

    Interface-compatible with :class:`WeightedFairScheduler` so the
    serve loop is discipline-agnostic; `pick_shed` is the global
    ``newest|oldest`` policy.
    """

    def __init__(self):
        self._q: collections.deque = collections.deque()

    def push(self, rid, tier: Optional[str] = None, cost: float = 1.0):
        self._q.append(rid)

    def push_front(self, rid):
        """Requeue a popped-but-unadmissible entry at the head (its
        original position relative to everything still queued)."""
        self._q.appendleft(rid)

    def pop(self):
        return self._q.popleft() if self._q else None

    def consume(self, rid):
        """The popped entry was admitted — nothing to forget here."""

    def remove(self, rid) -> bool:
        try:
            self._q.remove(rid)
            return True
        except ValueError:
            return False

    def ids(self) -> List:
        return list(self._q)

    def tier_of(self, rid) -> str:
        return DEFAULT_TIER

    def depths(self) -> Dict[str, int]:
        return {DEFAULT_TIER: len(self._q)} if self._q else {}

    def pick_shed(self, policy: str = "newest",
                  max_queue: Optional[int] = None):
        if not self._q:
            return None
        return self._q.pop() if policy == "newest" else self._q.popleft()

    def __len__(self):
        return len(self._q)


class _Tier:
    __slots__ = ("name", "weight", "q", "deficit")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = max(float(weight), 1e-9)
        self.q: collections.deque = collections.deque()  # (rid, cost)
        self.deficit = 0.0


class WeightedFairScheduler:
    """Deficit-round-robin scheduler over per-tier FIFO queues.

    `weights` maps tier name → relative admission share; unknown tiers
    get `default_weight`. `cost` is the request's service estimate (the
    serve loop passes prompt_len + max_new_tokens so fairness is in
    *work*, not request count); `quantum` is the deficit added per
    round in cost units.

    Not thread-safe by itself: the serve loop owns it.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 quantum: float = 64.0, default_weight: float = 1.0):
        self.weights = dict(weights or {})
        self.quantum = float(quantum)
        self.default_weight = float(default_weight)
        self._tiers: Dict[str, _Tier] = {}
        self._order: List[str] = []    # round-robin visit order
        self._ptr = 0
        self._need_grant = True   # quantum granted once per tier VISIT
        self._meta: Dict[object, tuple] = {}   # rid -> (tier, cost)
        self._n = 0

    # ------------------------------------------------------------ write --
    def _tier(self, name: str) -> _Tier:
        t = self._tiers.get(name)
        if t is None:
            w = self.weights.get(name, self.default_weight)
            t = self._tiers[name] = _Tier(name, w)
            self._order.append(name)
        return t

    def push(self, rid, tier: Optional[str] = None, cost: float = 1.0):
        tier = tier or DEFAULT_TIER
        cost = max(float(cost), 1e-9)
        self._tier(tier).q.append((rid, cost))
        self._meta[rid] = (tier, cost)
        self._n += 1

    def push_front(self, rid):
        """Requeue a popped-but-unadmissible entry at the head of its
        tier and refund the deficit its pop consumed — a request stuck
        waiting for pages must not burn its tier's share."""
        tier, cost = self._meta[rid]
        t = self._tier(tier)
        t.q.appendleft((rid, cost))
        t.deficit += cost
        self._n += 1

    def set_weight(self, tier: str, weight: float):
        """Live weight update (the controller's quantum shift): future
        DRR grants to `tier` use the new weight immediately. Safe to
        call from another thread — the grant reads a float the GIL
        keeps coherent, and fairness converges over rounds, so a
        mid-round change only skews the round it lands in."""
        w = max(float(weight), 1e-9)
        self.weights[tier] = w
        t = self._tiers.get(tier)
        if t is not None:
            t.weight = w

    # ------------------------------------------------------------- read --
    def pop(self):
        """Next request in DRR order (None when empty). The entry stays
        known to the scheduler until `consume` (admitted), `push_front`
        (requeued), or `remove` — the caller decides which.

        The quantum is granted ONCE per visit — when the round pointer
        arrives at a tier, not on every pop — and the pointer moves on
        as soon as the tier's deficit no longer covers its head. This
        is what bounds a tier's turn: granting per pop would let the
        first non-empty tier refill its own deficit forever and starve
        the rest."""
        if self._n == 0:
            return None
        while True:   # terminates: some tier is non-empty (_n > 0) and
            # its deficit grows by quantum*weight every full cycle
            name = self._order[self._ptr % len(self._order)]
            t = self._tiers[name]
            if not t.q:
                # empty tier: deficit does not accumulate while idle
                # (classic DRR), move on
                t.deficit = 0.0
                self._advance()
                continue
            if self._need_grant:
                t.deficit += self.quantum * t.weight
                self._need_grant = False
            rid, cost = t.q[0]
            if t.deficit >= cost:
                t.q.popleft()
                t.deficit -= cost
                self._n -= 1
                if not t.q:
                    t.deficit = 0.0
                return rid
            # can't afford the head with this visit's grant: carry the
            # deficit to the next round and give other tiers their turn
            self._advance()

    def _advance(self):
        self._ptr = (self._ptr + 1) % len(self._order)
        self._need_grant = True

    def consume(self, rid):
        self._meta.pop(rid, None)

    def remove(self, rid) -> bool:
        meta = self._meta.pop(rid, None)
        if meta is None:
            return False
        t = self._tiers[meta[0]]
        for i, (r, _) in enumerate(t.q):
            if r == rid:
                del t.q[i]
                self._n -= 1
                return True
        return False   # already popped (in flight) — meta only

    def ids(self) -> List:
        out = []
        for name in self._order:
            out.extend(r for r, _ in self._tiers[name].q)
        return out

    def tier_of(self, rid) -> str:
        meta = self._meta.get(rid)
        return meta[0] if meta else DEFAULT_TIER

    def depths(self) -> Dict[str, int]:
        return {name: len(t.q) for name, t in self._tiers.items() if t.q}

    def snapshot(self) -> Dict[str, dict]:
        return {name: {"weight": t.weight, "depth": len(t.q),
                       "deficit": round(t.deficit, 3)}
                for name, t in self._tiers.items()}

    # ------------------------------------------------------------- shed --
    def pick_shed(self, policy: str = "newest",
                  max_queue: Optional[int] = None):
        """Remove and return the next entry to shed: from the
        lowest-weight tier whose depth exceeds its weight share of
        `max_queue` (shares sum to max_queue, so over capacity at least
        one tier exceeds its share — a tier within its share is never
        shed). Within the tier, `policy` picks newest|oldest."""
        active = [t for t in self._tiers.values() if t.q]
        if not active:
            return None
        total_w = sum(t.weight for t in active)
        victim = None
        if max_queue is not None:
            over = [t for t in active
                    if len(t.q) > max_queue * t.weight / total_w]
            if over:
                victim = min(over, key=lambda t: t.weight)
        if victim is None:
            # No tier exceeds its share. Real overflow (Σ depth >
            # max_queue) guarantees at least one over-share tier, so
            # this only happens when the apparent depth is inflated
            # (e.g. the serve_flood fault site). Shedding anyway would
            # break the never-shed-within-share invariant — decline
            # and let the caller stop.
            return None
        rid, _ = victim.q.pop() if policy == "newest" \
            else victim.q.popleft()
        self._n -= 1
        self._meta.pop(rid, None)
        if not victim.q:
            victim.deficit = 0.0
        return rid

    def __len__(self):
        return self._n
