"""Serving defaults the continuous-batching predictor reads.

Counterpart of ``paddle_tpu/framework/runtime_config.py`` ``RuntimeConfig``
(the serving fields the port runs); the values and the validation equal
(every field, in the reference's order); the values and the validation
equal the reference's, so ``to_dict()`` and ``config_hash()`` of one
configuration are equal across the two packages and a config written by
the reference's tooling (``tools/autotune.py``) loads here.
``to_dict`` / ``from_dict`` round-trip it as plain JSON and
``config_hash`` is the reference's SHA-256 over the canonical form: the
AOT engine records both in its bundle manifest, and a disagreement on a
``COMPILED_FIELDS`` field invalidates the bundle at warm start. The
serving front end's fields (``max_queue``, ``shed_policy``,
``decode_watchdog_s``, ``wfs_quantum``) are runtime-only: they never
invalidate a bundle. ``from_flags()`` is the config the predictor takes
when it is given none: every field in ``MIGRATED_FLAG_KNOBS`` reads its
flag. ``for_role`` lays a serve role's ``ROLE_OVERLAYS`` over a config.

The training fields (``grad_bucket_bytes``, ``quantized_grad_comm``,
``zero_stage``) are carried and hashed; the one-device trainer reads
none of them. ``tp_degree`` must be 1 (``check_servable``): the port
serves on one device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["RuntimeConfig", "CONFIG_VERSION", "config_hash",
           "MIGRATED_FLAG_KNOBS", "COMPILED_FIELDS", "ROLE_OVERLAYS",
           "SERVE_ROLES", "check_servable"]

CONFIG_VERSION = 1

# the fields that shape what an AOT bundle captures (program shapes, the
# paged-pool layout, the admission and chunk buckets, the program
# variants): only a disagreement here invalidates a bundle at warm start
COMPILED_FIELDS = frozenset({
    "max_batch_size", "page_size", "num_pages", "max_seq_len",
    "prompt_buckets", "prefill_chunk_tokens",
    "spec_draft_tokens", "sampling_enabled",
    "tp_degree",
})

# flags whose knob lives in RuntimeConfig: flag name -> field
# (``from_flags`` reads each; the AOT warm start counts drift on these)
MIGRATED_FLAG_KNOBS = {
    "serve_prefill_chunk_tokens": "prefill_chunk_tokens",
    "serve_decode_watchdog_s": "decode_watchdog_s",
    "serve_spec_draft_tokens": "spec_draft_tokens",
    "serve_spec_ngram_max": "spec_ngram_max",
    "serve_sampling": "sampling_enabled",
    "serve_tp_degree": "tp_degree",
    "grad_bucket_bytes": "grad_bucket_bytes",
    "quantized_grad_comm": "quantized_grad_comm",
    "serve_role": "serve_role",
}

# disaggregated serving roles: "unified" prefills and decodes, "prefill"
# fills the pages and hands off at the first token, "decode" resumes from
# an imported KV page span
SERVE_ROLES = ("unified", "prefill", "decode")

# the field deltas ``for_role`` lays over a base config: a prefill
# replica stops at the first token (no speculative or sampling decode
# programs), a decode replica never ingests a prompt in chunks
ROLE_OVERLAYS = {
    "unified": {},
    "prefill": {"spec_draft_tokens": 0, "sampling_enabled": False},
    "decode": {"prefill_chunk_tokens": 0},
}


@dataclass(frozen=True)
class RuntimeConfig:
    version: int = CONFIG_VERSION
    max_batch_size: int = 4
    page_size: int = 16
    num_pages: Optional[int] = None        # None: B * pages_per_seq
    max_seq_len: int = 512
    # admission prompt-length buckets; () = power-of-two auto bucketing
    prompt_buckets: Tuple[int, ...] = ()
    prefill_chunk_tokens: int = 0          # 0 = monolithic prefill
    # speculative decoding: max drafted tokens per verify step (the
    # verify span is spec_draft_tokens + 1 wide); 0 = off
    spec_draft_tokens: int = 0
    # prompt-lookup drafting: longest suffix n-gram matched against the
    # request's own prompt + generation history
    spec_ngram_max: int = 3
    # on-device sampling: the decode and verify steps take per-request
    # temperature / top-k / top-p / seed operands; off = greedy only
    sampling_enabled: bool = False
    tp_degree: int = 1                     # one device
    # the serve role of the replica this config drives (SERVE_ROLES);
    # not a compiled field: a bundle records it beside its topology and
    # a mismatch invalidates with reason "role"
    serve_role: str = "unified"
    # serving robustness and fairness (runtime-only)
    max_queue: Optional[int] = None        # None = unbounded backlog
    shed_policy: str = "newest"
    decode_watchdog_s: float = 0.0         # 0 = disabled
    wfs_quantum: float = 64.0              # WeightedFairScheduler grant
    # training communication (carried and hashed; unread on one device)
    grad_bucket_bytes: int = 32 * 1024 * 1024
    quantized_grad_comm: bool = False
    # ZeRO stage: 0 plain data parallel .. 3 parameters sharded
    zero_stage: int = 0

    def __post_init__(self):
        if self.version != CONFIG_VERSION:
            raise ValueError(
                f"RuntimeConfig schema version {self.version} is not "
                f"supported (this build speaks version {CONFIG_VERSION})")
        if self.shed_policy not in ("newest", "oldest"):
            raise ValueError(
                f"shed_policy must be 'newest' or 'oldest', got "
                f"{self.shed_policy!r}")
        if self.page_size <= 0 or self.max_batch_size <= 0 \
                or self.max_seq_len <= 0:
            raise ValueError("geometry fields must be positive")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(
                f"zero_stage must be 0..3, got {self.zero_stage!r}")
        if self.spec_draft_tokens < 0 or self.spec_ngram_max < 1:
            raise ValueError(
                "spec_draft_tokens must be >= 0 and spec_ngram_max "
                f">= 1, got {self.spec_draft_tokens!r}/"
                f"{self.spec_ngram_max!r}")
        check_servable(self.tp_degree, self.serve_role)
        # normalize buckets: sorted unique ints (hash stability)
        object.__setattr__(
            self, "prompt_buckets",
            tuple(sorted({int(b) for b in self.prompt_buckets})))

    @classmethod
    def from_flags(cls) -> "RuntimeConfig":
        """The config whose ``MIGRATED_FLAG_KNOBS`` fields come from the
        flag registry (``framework.flags``); every other field keeps its
        default."""
        from .flags import flag_value
        return cls(
            prefill_chunk_tokens=int(
                flag_value("serve_prefill_chunk_tokens")),
            decode_watchdog_s=float(flag_value("serve_decode_watchdog_s")),
            spec_draft_tokens=int(flag_value("serve_spec_draft_tokens")),
            spec_ngram_max=int(flag_value("serve_spec_ngram_max")),
            sampling_enabled=bool(flag_value("serve_sampling")),
            tp_degree=int(flag_value("serve_tp_degree")),
            grad_bucket_bytes=int(flag_value("grad_bucket_bytes")),
            quantized_grad_comm=bool(flag_value("quantized_grad_comm")),
            serve_role=str(flag_value("serve_role")),
        )

    def for_role(self, role: str, **extra) -> "RuntimeConfig":
        """This config specialised for a serve role: ``ROLE_OVERLAYS[role]``
        and then ``extra`` laid over it, ``serve_role`` set to ``role``."""
        if role not in SERVE_ROLES:
            raise ValueError(
                f"serve_role must be one of {SERVE_ROLES}, got {role!r}")
        kw = dict(ROLE_OVERLAYS[role])
        kw.update(extra)
        kw["serve_role"] = role
        return self.replace(**kw)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["prompt_buckets"] = list(self.prompt_buckets)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "RuntimeConfig":
        """Inverse of ``to_dict``. Unknown keys are rejected: a manifest
        written by a newer schema must not load with half its knobs
        dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown RuntimeConfig field(s): {sorted(unknown)}")
        kw = dict(d)
        if kw.get("prompt_buckets") is not None:
            kw["prompt_buckets"] = tuple(kw["prompt_buckets"])
        return cls(**kw)

    def replace(self, **kw) -> "RuntimeConfig":
        return dataclasses.replace(self, **kw)

    def config_hash(self) -> str:
        return config_hash(self.to_dict())

    def diff(self, other: "RuntimeConfig") -> Dict[str, tuple]:
        """{field: (self_value, other_value)} for every disagreement."""
        a, b = self.to_dict(), other.to_dict()
        return {k: (a[k], b[k]) for k in a if a[k] != b[k]}


def check_servable(tp_degree, serve_role) -> None:
    """Raise unless the port can serve this tensor-parallel degree (one
    device) and role (one of ``SERVE_ROLES``)."""
    if int(tp_degree) != 1:
        raise ValueError(f"tp_degree={tp_degree!r}: the port serves on one "
                         "device (tp_degree=1) only")
    if serve_role not in SERVE_ROLES:
        raise ValueError(f"serve_role must be one of {SERVE_ROLES}, got "
                         f"{serve_role!r}")


def config_hash(d: Dict) -> str:
    """SHA-256 of the canonical JSON form (the reference's)."""
    return hashlib.sha256(
        json.dumps(d, sort_keys=True, separators=(",", ":"),
                   default=str).encode()).hexdigest()
