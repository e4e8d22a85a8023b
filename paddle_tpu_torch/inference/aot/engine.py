"""AOT inference engine: warm-start serving with nothing traced or built
on the hot path (counterpart of ``paddle_tpu/inference/aot/engine.py``).

The PyTorch counterpart of dispatching a precompiled executable is
replaying a captured CUDA graph. The engine is the signature -> program
table that ``ContinuousBatchingPredictor._jit_call`` consults:

- attaching a predictor (``warm_start`` does) captures every program the
  bundle records: each runs once on operands that send every K/V write
  to the trash page (the warm-up a capture needs: libraries load, Triton
  compiles), then is captured into one CUDA graph. All graphs share one
  memory pool (``torch.cuda.graph_pool_handle()``); the serve loop runs
  them one at a time on one stream, and every output is cloned out of the
  pool before the next replay.
- a hit copies the operands into the program's static input buffers,
  replays the graph, adds the launch counts its capture recorded
  (``kernels.launch_counts``: a replay runs no Python) and returns clones
  of its outputs (``aot.counters["bundle_hits"]`` and the reference's
  ``aot.bundle_hits`` series, by program kind).
- a miss (``compile_fallback``) runs the step eagerly once and serves
  that result, then captures the program and writes its signature back
  into the bundle, so the next process hits it
  (``aot.counters["bucket_misses"]`` / ``aot.bucket_misses``, inside an
  ``aot.compile_fallback`` span; the builder's misses are
  ``aot.build_program`` spans and count nowhere).

On a CPU predictor a program is the eager function, the CPU route, as a
kernel's plain version is. On CUDA a program is a graph: a capture or a
replay that fails raises, and nothing falls back to eager dispatch except
the counted bucket miss.

Invalidation is the reference's: a bundle whose runtime fingerprint,
model hash, kernel digests, compiled-in geometry, runtime config,
topology or role disagrees is rejected (``aot.counters
["invalidations"]`` by reason, ``aot.invalidations`` by reason and
tier), re-created empty and refilled by
write-back; ``strict=True`` raises instead. Weights and pages are baked
into every graph by address: the engine records them at attach and
refuses to serve once one was rebound (loading a checkpoint in place
keeps them).
"""
from __future__ import annotations

import collections
import logging
import os
import shutil
import threading
import time
from typing import Dict, Optional

import torch

from ...framework import integrity as _integrity
from ...framework.graphs import GraphProgram, capture_stream
from ...kernels import _build
from ...observability import metrics as _obsm
from ...observability import tracing as _obstr
from .bundle import (EngineBundle, BundleInvalid, runtime_fingerprint,
                     model_fingerprint, sig_key)

__all__ = ["InferenceEngine", "load_engine", "warm_start",
           "wire_kernel_cache", "default_engine_dir", "counters",
           "reset_counters", "COMPILED_GEOMETRY_KEYS"]

_logger = logging.getLogger("paddle_tpu_torch.aot")

# predictor arguments baked INTO the captured programs (shapes, the paged
# pool layout, eos/pad semantics, the program variants): a differing
# value at warm_start invalidates the bundle; everything else (the prefix
# cache, drafting policy) is runtime-only. The reference's set.
COMPILED_GEOMETRY_KEYS = frozenset({
    "max_batch_size", "page_size", "max_seq_len", "num_pages",
    "pad_token_id", "eos_token_id", "kv_dtype", "use_ragged",
    "prefill_chunk_tokens", "spec_draft_tokens", "sampling_enabled",
    "tp_degree", "role",
})

# the engine's counters, as ``kernels.launch_counts`` keeps launches:
# bundle_hits and bucket_misses by program kind, invalidations by reason
counters = {"bundle_hits": collections.Counter(),
            "bucket_misses": collections.Counter(),
            "invalidations": collections.Counter()}


def reset_counters() -> None:
    for c in counters.values():
        c.clear()


def _serve_topology(tp) -> str:
    """The reference's topology string for a TP degree."""
    tp = int(tp or 1)
    return f"model={tp}" if tp > 1 else "replicated"


def default_engine_dir() -> Optional[str]:
    """Engine path handed down by the environment
    (``PADDLE_TPU_ENGINE_DIR``, as in the reference)."""
    return os.environ.get("PADDLE_TPU_ENGINE_DIR") or None


def _invalidate(reason: str, detail: str = "", tier: str = "bundle"):
    counters["invalidations"][reason] += 1
    _obsm.counter("aot.invalidations").inc(reason=reason, tier=tier)
    _logger.warning("aot %s invalidated (%s)%s", tier, reason,
                    f": {detail}" if detail else "")


def wire_kernel_cache(cache_dir: str, device=None) -> tuple:
    """Point the kernel build directory and Triton's cache at
    ``cache_dir`` (the counterpart of the reference's ``wire_xla_cache``,
    which points XLA's persistent compilation cache at the bundle),
    fenced by a runtime-fingerprint file: a directory written by another
    runtime is wiped (counted under the ``fingerprint`` reason) instead
    of loading a stale library. Returns the previous (build directory,
    Triton cache directory)."""
    cache_dir = os.path.abspath(cache_dir)
    fp_path = os.path.join(cache_dir, ".cache_fingerprint.json")
    cur = runtime_fingerprint(device)
    if os.path.isdir(cache_dir):
        prev = _integrity.read_json(fp_path)
        if prev is not None and prev != cur:
            _invalidate("fingerprint", f"{prev} -> {cur}",
                        tier="kernel_cache")
            shutil.rmtree(cache_dir, ignore_errors=True)
    os.makedirs(cache_dir, exist_ok=True)
    if not os.path.exists(fp_path):
        _integrity.atomic_write_json(fp_path, cur)
    return _build.set_build_dir(cache_dir)


class InferenceEngine:
    """Signature -> program table consulted by
    ``ContinuousBatchingPredictor._jit_call``.

    - ``attach(predictor)``: captures every program the bundle records
      (digest-verified; a corrupt record is counted and skipped, so its
      signature misses and the write-back repairs it).
    - ``get(sig)``: the program, or None; a program from the bundle
      counts as a hit.
    - ``compile_fallback(sig, fn, args)``: the bucket-miss path.
    - ``recording=True`` (the builder's mode): misses are calibration
      work and are not counted as bucket misses.
    - ``program(sig)``: a program without hit accounting.
    """

    def __init__(self, bundle: Optional[EngineBundle] = None,
                 write_back: bool = True, recording: bool = False):
        self.bundle = bundle
        self.write_back = bool(write_back)
        self.recording = bool(recording)
        self._lock = threading.Lock()
        self._table: Dict[tuple, object] = {}   # sig -> program
        self._origin: Dict[tuple, str] = {}     # sig -> bundle|fallback
        self.stats = {"hits": 0, "misses": 0, "loads": 0,
                      "write_backs": 0, "capture_s": 0.0}
        self._m_hit = _obsm.counter("aot.bundle_hits")
        self._m_miss = _obsm.counter("aot.bucket_misses")
        self.predictor = None
        self._pool = None
        self._bound = []
        # warm-ness is what the bundle held at START: this session's own
        # write-backs do not relabel a cold start as warm
        self.warm = bool(bundle is not None and bundle.exists()
                         and bundle.artifacts())

    # ---------------------------------------------------------- attach --
    def attach(self, predictor):
        """Bind the predictor whose programs this engine serves and
        capture every program its bundle records."""
        if self.predictor is not None and self.predictor is not predictor:
            raise RuntimeError("an InferenceEngine serves one predictor: "
                               "its graphs hold that predictor's pages")
        self.predictor = predictor
        self._bound = [(t, t.data_ptr()) for t in self._baked(predictor)]
        if self.bundle is None:
            return
        t0 = time.perf_counter()
        for key in sorted(self.bundle.artifacts()):
            try:
                sig = self.bundle.load_artifact(key)
            except BundleInvalid as e:
                # one corrupt record poisons only itself: its signature
                # misses and the write-back repairs it
                _invalidate(e.reason, e.detail)
                continue
            if sig is None or sig[0] == "custom":
                continue     # a custom program is captured by its owner
            fn, args = predictor._idle_program(sig)
            self._table[sig] = self._capture(fn, args, warm_up=True)
            self._origin[sig] = "bundle"
            self.stats["loads"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    @staticmethod
    def _baked(predictor):
        """The tensors every graph reads by address: the weights, the
        buffers and the KV pages."""
        m = predictor.model
        return [*m.parameters(), *m.buffers(), *predictor.pool.k,
                *predictor.pool.v]

    def check_bindings(self):
        """Raise when a weight, buffer or page tensor was rebound since
        the programs were captured (a graph would read the old storage);
        warm-start again after such a change."""
        if self.predictor is None:
            return
        now = self._baked(self.predictor)
        if len(now) != len(self._bound) or any(
                t is not b or t.data_ptr() != p
                for t, (b, p) in zip(now, self._bound)):
            raise RuntimeError(
                "a weight or KV page tensor was rebound after the engine "
                "captured its programs; load checkpoints in place, or "
                "warm-start a new predictor")

    def _capture(self, fn, args, warm_up):
        """A program for ``fn`` on operands shaped like ``args``: ``fn``
        itself on the CPU (the CPU route); on CUDA a graph, after one
        eager warm-up run on the capture stream when ``warm_up`` (the
        caller's operands must then write nothing real)."""
        dev = self.predictor.device
        if dev.type != "cuda":
            return fn
        stream = capture_stream(dev)
        if warm_up:
            cur = torch.cuda.current_stream(dev)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                fn(*args)
            cur.wait_stream(stream)
        if self._pool is None:
            # a pool of the engine's own, not generate()'s: a pool's memory
            # goes back to the allocator only once every graph captured
            # into it is freed, so the engine's goes with the engine
            self._pool = torch.cuda.graph_pool_handle()
        return GraphProgram(fn, args, self._pool, stream)

    # ------------------------------------------------------------ serve --
    def get(self, sig):
        hit = self._table.get(sig)
        if hit is not None and self._origin.get(sig) == "bundle":
            # hits count dispatches served by programs the bundle held;
            # a fallback re-dispatching from the table does not
            self.stats["hits"] += 1
            counters["bundle_hits"][str(sig[0])] += 1
            self._m_hit.inc(kind=str(sig[0]))
        return hit

    def compile_fallback(self, sig, fn, args):
        """Bucket miss: run the step eagerly once and serve that result,
        then capture the program, keep it and record its signature in
        the bundle."""
        key = sig_key(sig)
        kind = str(sig[0]) if isinstance(sig, tuple) and sig else "?"
        self.stats["misses"] += 1
        if self.recording:
            sp = _obstr.start_span("aot.build_program", parent=None,
                                   kind=kind, sig=key[:160])
        else:
            counters["bucket_misses"][kind] += 1
            self._m_miss.inc(kind=kind)
            _logger.warning("aot bucket miss: %s", key[:160])
            sp = _obstr.start_span("aot.compile_fallback", parent=None,
                                   kind=kind, sig=key[:160])
        try:
            out = fn(*args)
            t0 = time.perf_counter()
            prog = self._capture(fn, args, warm_up=False)
            self.stats["capture_s"] += time.perf_counter() - t0
            with self._lock:
                self._table[sig] = prog
                self._origin[sig] = "fallback"
            if self.write_back and self.bundle is not None:
                try:
                    rec = self.bundle.add_artifact(sig)
                    self.stats["write_backs"] += 1
                    sp.event("write_back", file=rec["file"],
                             bytes=rec["bytes"])
                except (OSError, BundleInvalid) as e:
                    # persistence is best-effort: serving never dies of it
                    _logger.warning("aot write-back of %s failed: %s",
                                    key[:160], e)
                    sp.event("write_back_failed",
                             error=f"{type(e).__name__}: {e}"[:160])
            sp.end(status="ok")
        except BaseException as e:
            sp.end(status=f"error:{type(e).__name__}")
            raise
        return out

    def program(self, sig):
        """A program by signature, without hit accounting (None when the
        engine holds none)."""
        return self._table.get(sig)


# ---------------------------------------------------------------------------
# load / warm-start
# ---------------------------------------------------------------------------
def load_engine(path: str, model=None, write_back: bool = True,
                wire_cache: bool = True) -> InferenceEngine:
    """Open a bundle for serving. Validates the runtime fingerprint, the
    kernel files' digests and (when ``model`` is given) the model hash
    BEFORE anything is captured; a mismatch raises :class:`BundleInvalid`
    after counting it. Program records verify at attach. With
    ``wire_cache`` the kernel build directory points at the bundle's."""
    bundle = EngineBundle(path)
    device = model.device if model is not None else None
    with _obstr.span("aot.load", parent=None, path=path) as sp:
        try:
            m = bundle.validate(model_fingerprint(model)
                                if model is not None else None, device)
        except BundleInvalid as e:
            _invalidate(e.reason, e.detail)
            sp.event("invalidated", reason=e.reason)
            raise
        if wire_cache:
            wire_kernel_cache(bundle.kernel_dir, device)
        eng = InferenceEngine(bundle, write_back=write_back)
        sp.set_label(artifacts=len(m.get("artifacts", {})))
    return eng


def _named_kv_dtype(cb_kwargs: Dict) -> Dict:
    """``cb_kwargs`` with a ``kv_dtype`` given as a torch dtype named as
    the manifest records it ("bfloat16"), so that it is written and
    compared as the reference's string."""
    from ...generation.kv_cache import kv_dtype_name
    out = dict(cb_kwargs)
    if out.get("kv_dtype") is not None:
        out["kv_dtype"] = kv_dtype_name(out["kv_dtype"])
    return out


def warm_start(model, path: Optional[str] = None, strict: bool = False,
               wire_cache: bool = True, runtime_config=None,
               **cb_kwargs):
    """Build a ``ContinuousBatchingPredictor`` warm-started from the
    engine bundle at ``path`` (default ``$PADDLE_TPU_ENGINE_DIR``): every
    recorded program is captured before this returns, on the model's
    device.

    Geometry comes from the bundle manifest; explicit ``cb_kwargs``
    override it, but an override that CHANGES compiled-in geometry
    (``COMPILED_GEOMETRY_KEYS``) invalidates the bundle, and so do a
    requested topology or role other than the bundle's, and a
    ``runtime_config`` that disagrees on a ``COMPILED_FIELDS`` field (or
    one passed against a bundle that recorded none). Without an explicit
    config the bundle's own drives the predictor.

    On ANY invalidation (corrupt manifest, fingerprint, model hash or
    kernel digest mismatch, geometry, runtime config, topology, role)
    the bundle is counted, re-created empty, and the predictor starts
    cold: its misses capture and write back into the fresh bundle. With
    ``strict=True`` the invalidation raises instead.

    Returns ``(predictor, engine)``."""
    from ..predictor import ContinuousBatchingPredictor
    from ...framework.runtime_config import RuntimeConfig, COMPILED_FIELDS
    cb_kwargs = _named_kv_dtype(cb_kwargs)
    path = path or default_engine_dir()
    if not path:
        raise ValueError("warm_start needs an engine path (argument or "
                         "PADDLE_TPU_ENGINE_DIR)")
    mh = model_fingerprint(model)
    geometry: Dict = {}
    eff_rc = runtime_config
    try:
        engine = load_engine(path, model=model, wire_cache=wire_cache)
        geometry = dict(engine.bundle.manifest().get("geometry", {}))
        # topology first: the partitioning is compiled into every program
        want_tp = cb_kwargs.get("tp_degree")
        if want_tp is None and runtime_config is not None:
            want_tp = runtime_config.tp_degree
        if want_tp is not None:
            got_topo = geometry.get(
                "mesh_topology",
                _serve_topology(geometry.get("tp_degree", 1)))
            want_topo = _serve_topology(want_tp)
            if got_topo != want_topo:
                raise BundleInvalid(
                    "topology", f"bundle partitioned for {got_topo!r}, "
                    f"requested {want_topo!r}")
        # role second: a per-role bundle carries a per-role program set
        want_role = cb_kwargs.get("role")
        if want_role is None and runtime_config is not None:
            want_role = runtime_config.serve_role
        if want_role is not None:
            got_role = geometry.get("role", "unified")
            if got_role != want_role:
                raise BundleInvalid(
                    "role", f"bundle built for role {got_role!r}, "
                    f"requested {want_role!r}")
        changed = {k: v for k, v in cb_kwargs.items()
                   if k in COMPILED_GEOMETRY_KEYS and k in geometry
                   and geometry[k] != v}
        if changed:
            raise BundleInvalid(
                "geometry", f"overrides change compiled-in geometry: "
                            f"{sorted(changed)}")
        m = engine.bundle.manifest()
        bundle_rc_d = m.get("runtime_config")
        if bundle_rc_d is not None:
            try:
                bundle_rc = RuntimeConfig.from_dict(bundle_rc_d)
            except (TypeError, ValueError) as e:
                raise BundleInvalid("runtime_config",
                                    f"unreadable baked config: {e}")
            if runtime_config is not None:
                # only a COMPILED disagreement invalidates; an "auto"
                # request (num_pages None, no bucket table) takes the
                # builder's values
                rq = runtime_config.to_dict()
                changed = sorted(
                    k for k in set(bundle_rc.diff(runtime_config))
                    & COMPILED_FIELDS
                    if not (k in ("num_pages", "prompt_buckets")
                            and rq[k] in (None, [])))
                if changed:
                    raise BundleInvalid(
                        "runtime_config",
                        f"bundle config "
                        f"{str(m.get('runtime_config_hash'))[:12]}... "
                        f"vs requested "
                        f"{runtime_config.config_hash()[:12]}... "
                        f"(compiled fields: {changed})")
                fills = {}
                if runtime_config.num_pages is None:
                    fills["num_pages"] = bundle_rc.num_pages
                if not runtime_config.prompt_buckets:
                    fills["prompt_buckets"] = bundle_rc.prompt_buckets
                if fills:
                    eff_rc = runtime_config.replace(**fills)
            if eff_rc is None:
                eff_rc = bundle_rc
        elif runtime_config is not None:
            raise BundleInvalid(
                "runtime_config",
                "bundle predates runtime_config; rebuild to deploy an "
                "explicit config")
    except BundleInvalid as e:
        if strict:
            raise
        if e.reason in ("geometry", "runtime_config", "topology", "role"):
            _invalidate(e.reason, e.detail)  # load_engine counted others
        geometry = {}
        bundle = EngineBundle.create(
            path, mh, {**cb_kwargs}, buckets={},
            runtime_config=(runtime_config.to_dict()
                            if runtime_config is not None else None),
            device=model.device)
        if wire_cache:
            wire_kernel_cache(bundle.kernel_dir, model.device)
        engine = InferenceEngine(bundle, write_back=True)
        eff_rc = runtime_config
    kw = {**geometry, **cb_kwargs}
    kw.pop("mesh_topology", None)      # manifest-only, not an argument
    kw.setdefault("device", model.device)
    predictor = ContinuousBatchingPredictor(model, engine=engine,
                                            runtime_config=eff_rc, **kw)
    if not geometry:
        # reset path: persist the EFFECTIVE geometry (defaults resolved)
        # so the next warm_start rebuilds an identical predictor
        try:
            engine.bundle.set_geometry({
                "max_batch_size": predictor.B,
                "page_size": predictor.page,
                "max_seq_len": predictor.max_seq_len,
                "num_pages": predictor.capacity,
                "pad_token_id": predictor.pad_token_id,
                "eos_token_id": predictor.eos_token_id,
                "tp_degree": predictor.tp,
                "mesh_topology": predictor.tp_topology,
                "role": predictor.role,
                **{k: v for k, v in cb_kwargs.items()
                   if isinstance(v, (int, float, str, bool,
                                     type(None)))}})
        except BundleInvalid:
            pass
    return predictor, engine
