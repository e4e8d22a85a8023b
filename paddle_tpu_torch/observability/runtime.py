"""Runtime glue: device-value recording, device memory watermarks, the
process auto-sink, and per-rank heartbeats (counterpart of
``paddle_tpu/observability/runtime.py``).

The contract with device code: metrics NEVER force a device sync. A
device value reaches the registry through :func:`jit_callback` (an
asynchronous copy into pinned host memory behind a CUDA event, read on
the host once the event has completed), and ONLY when telemetry is
enabled — with telemetry disabled it copies nothing. A host callback
cannot be replayed by a CUDA graph, so a call inside a capture raises.
"""
from __future__ import annotations

import collections
import gc
import json
import os
import threading
import time
from typing import Callable, Optional

import torch

from .metrics import enabled, get_registry

__all__ = ["jit_callback", "device_memory_stats", "configure",
           "maybe_export", "export_record", "telemetry_path",
           "RankHeartbeat", "rank_identity", "set_identity",
           "export_identity"]


# ------------------------------------------------------- rank identity ------
# Fleet observability (the reference's docs/OBSERVABILITY.md "Fleet view")
# joins telemetry across ranks, which only works if every exported line says which rank
# wrote it. The identity is sourced once from the launcher env
# (PADDLE_TRAINER_ID/RANK, PADDLE_TRAINERS_NUM/WORLD_SIZE,
# PADDLE_TPU_TOPOLOGY) and merged into every JSONL record by the sink;
# single-process runs (no rank env) keep their line schema unchanged.
_identity: Optional[dict] = None


def _env_identity() -> dict:
    rank = os.environ.get("PADDLE_TRAINER_ID", os.environ.get("RANK"))
    if rank is None:
        return {}
    out = {"rank": int(rank)}
    ws = os.environ.get("PADDLE_TRAINERS_NUM",
                        os.environ.get("WORLD_SIZE"))
    if ws is not None:
        out["world_size"] = int(ws)
    topo = os.environ.get("PADDLE_TPU_TOPOLOGY")
    if topo:
        out["topology"] = topo
    return out


def rank_identity() -> dict:
    """This process's fleet identity: `{"rank", "world_size",
    "topology"}` (any subset; `{}` outside a launcher). Cached on first
    read; `set_identity` overrides."""
    global _identity
    if _identity is None:
        try:
            _identity = _env_identity()
        except (TypeError, ValueError):
            _identity = {}
    return dict(_identity)


def export_identity() -> dict:
    """The identity exporters stamp on every record: the full
    rank_identity() under a launcher, `{}` otherwise. Gated on a
    ``rank`` being present so a process-local topology stamp
    (`HybridTrainStep` in a single-process run) cannot change the
    single-process line schema — outside a launcher, telemetry lines
    and Prometheus labels stay exactly as they always were."""
    ident = rank_identity()
    return ident if "rank" in ident else {}


def set_identity(rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 topology: Optional[str] = None) -> dict:
    """Override/extend the cached identity (the hybrid engine names its
    mesh topology here so rank files record the layout they ran under).
    Only the given fields change; returns the resulting identity. An
    already-attached process sink picks the change up immediately."""
    global _identity
    ident = rank_identity()
    if rank is not None:
        ident["rank"] = int(rank)
    if world_size is not None:
        ident["world_size"] = int(world_size)
    if topology is not None:
        ident["topology"] = str(topology)
    _identity = ident
    with _Sink.lock:
        if _sink.exporter is not None:
            _sink.exporter.identity = export_identity()
    return dict(ident)


def _guarded(fn, vals):
    if not enabled():      # runtime toggle after the record: drop
        return
    try:
        fn(*vals)
    except Exception:
        pass               # telemetry must never kill a step


# callbacks whose device values are still in flight: (event, host
# copies, fn), in record order
_pending: "collections.deque" = collections.deque()
_pending_lock = threading.Lock()


def _poll_callbacks():
    """Run, in record order, the pending callbacks whose copies have
    completed (``Event.query()``: never blocks); stops at the first one
    still in flight."""
    while True:
        with _pending_lock:
            if not _pending or not _pending[0][0].query():
                return
            _, host, fn = _pending.popleft()
        _guarded(fn, [h.numpy() for h in host])


def jit_callback(fn: Callable, *tensors):
    """Record device values host-side without a sync (the counterpart of
    the reference's ``jax.debug.callback`` route).

    ``fn(*numpy_arrays)`` runs on the host once the values are there: on
    CUDA each tensor is copied into pinned host memory ``non_blocking``
    behind a recorded event, and ``fn`` runs when a later record or
    export finds that event completed (nothing here ever calls
    ``synchronize()``). On the CPU ``fn`` runs at once. Inside a
    CUDA-graph capture it raises: a host callback cannot be replayed,
    and a silent no-op would lose the value. A no-op when telemetry is
    disabled; an exception in ``fn`` never propagates."""
    if not enabled():
        return
    cuda = [t for t in tensors
            if isinstance(t, torch.Tensor) and t.is_cuda]
    if not cuda:
        _poll_callbacks()
        _guarded(fn, [t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t for t in tensors])
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "observability.jit_callback inside a CUDA-graph capture: a "
            "host callback cannot be replayed; record the value around "
            "the captured program instead")
    _poll_callbacks()
    host = []
    for t in tensors:
        t = t.detach()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(cuda[0].device))
    with _pending_lock:
        _pending.append((ev, host, fn))


def device_memory_stats(device=None) -> dict:
    """Best-effort device memory watermark, no sync.

    On a CUDA device the caching allocator's counters
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` /
    ``.peak``, source ``"memory_stats"``). On the CPU the bytes of every
    live CPU tensor's storage (source ``"live_tensors"``: an upper
    bound that tracks leaks the same way). Returns {"bytes_in_use",
    "peak_bytes_in_use", "source"}, the reference's keys."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        cur = int(stats.get("allocated_bytes.all.current", 0))
        return {"bytes_in_use": cur,
                "peak_bytes_in_use": int(
                    stats.get("allocated_bytes.all.peak", cur)),
                "source": "memory_stats"}
    seen = set()
    live = 0
    for o in gc.get_objects():
        # type(), not isinstance(): isinstance reads __class__, which
        # some module-level objects answer with a deprecation warning
        if issubclass(type(o), torch.Tensor) and o.device.type == "cpu":
            st = o.untyped_storage()
            try:
                key = st.data_ptr()
            except RuntimeError:
                # a fake or functional tensor (a torch.export trace can
                # leave some alive) owns no memory
                continue
            if key and key not in seen:
                seen.add(key)
                live += st.nbytes()
    return {"bytes_in_use": live, "peak_bytes_in_use": live,
            "source": "live_tensors"}


# --------------------------------------------------------------- sink ------
class _Sink:
    lock = threading.Lock()
    exporter = None          # JsonlExporter
    every = 1                # export every N maybe_export calls
    _calls = 0


_sink = _Sink()
_atexit_registered = False


def _close_sink_at_exit():
    """Interpreter-teardown flush: the last partial snapshot (or span)
    written just before exit must reach disk even when the owner never
    called configure(None). JsonlExporter.close() is idempotent, so a
    sink closed earlier by hand is a no-op here."""
    with _Sink.lock:
        exp, _sink.exporter = _sink.exporter, None
    if exp is not None:
        exp.close()


def configure(jsonl_path: Optional[str] = None, every: int = 1):
    """Attach (or detach, with None) the process JSONL telemetry sink.

    Instrumented hot paths call `maybe_export(step=...)` once per step;
    with a sink configured that appends one registry snapshot every
    `every` calls. Env default: PADDLE_TPU_TELEMETRY_JSONL. The sink is
    flushed and closed at interpreter exit (atexit) if still attached.
    """
    global _atexit_registered
    from .exporters import JsonlExporter
    with _Sink.lock:
        if _sink.exporter is not None:
            _sink.exporter.close()
            _sink.exporter = None
        if jsonl_path:
            _sink.exporter = JsonlExporter(jsonl_path)
        _sink.every = max(1, int(every))
        _sink._calls = 0
    if not _atexit_registered:
        _atexit_registered = True
        import atexit
        atexit.register(_close_sink_at_exit)


def telemetry_path() -> Optional[str]:
    return _sink.exporter.path if _sink.exporter is not None else None


_env_checked = False


def _ensure_env_sink():
    global _env_checked
    if _env_checked or _sink.exporter is not None:
        return
    _env_checked = True
    path = os.environ.get("PADDLE_TPU_TELEMETRY_JSONL")
    if path:
        configure(path)


def maybe_export(step: Optional[int] = None):
    """Flush a registry snapshot to the configured JSONL sink (no-op
    when telemetry is disabled or no sink is configured). Runs the
    device-value callbacks that have completed first."""
    if not enabled():
        return
    _poll_callbacks()
    _ensure_env_sink()
    with _Sink.lock:
        exp = _sink.exporter
        if exp is None:
            return
        _sink._calls += 1
        if (_sink._calls % _sink.every) != 0:
            return
        exp.export(step=step)


def export_record(rec: dict):
    """Write one raw record (span lines, one-off run metadata) through
    the process JSONL sink; silent no-op without a sink. This is how
    tracing.Span.end lands `{"kind": "span"}` lines in the same file as
    the metric samples."""
    if not enabled():
        return
    _ensure_env_sink()
    with _Sink.lock:
        exp = _sink.exporter
        if exp is None:
            return
        exp.write_record(rec)


# ---------------------------------------------------------- heartbeat ------
class RankHeartbeat:
    """Per-rank liveness lines so a wedged rank is diagnosable.

    Appends JSONL lines {"ts", "kind": "heartbeat", "rank"/"epoch", ...}
    at most once per `interval` seconds; `beat(**fields)` is safe to
    call every loop tick. interval <= 0 disables."""

    def __init__(self, path: str, interval: float = 1.0):
        self.path = path
        self.interval = float(interval)
        self._last = 0.0
        self._f = None
        if self.interval > 0:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def due(self) -> bool:
        """True when the next beat would actually write — check before
        building an expensive snapshot payload every loop tick."""
        return (self._f is not None
                and time.time() - self._last >= self.interval)

    def beat(self, force: bool = False, **fields) -> bool:
        if self._f is None:
            return False
        now = time.time()
        if not force and now - self._last < self.interval:
            return False
        try:  # heartbeat_stall fault: the process stays alive but its
            # heartbeat goes silent — the wedged-rank signature the
            # launcher's stale-heartbeat detector exists to catch
            from ..framework import faults as _faults
            fa = _faults.check("heartbeat_stall")
            if fa is not None:
                self._stalled_until = now + float(
                    fa.params.get("sleep", 3600.0))
        except Exception:
            pass
        if now < getattr(self, "_stalled_until", 0.0):
            return False
        self._last = now
        rec = {"ts": round(now, 3), "kind": "heartbeat"}
        rec.update(fields)
        try:
            self._f.write(json.dumps(rec) + "\n")
        except Exception:
            return False
        return True

    def close(self):
        if self._f is not None:
            try:
                self._f.close()
            except Exception:
                pass
            self._f = None
