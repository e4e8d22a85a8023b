"""Engine builder: calibrate, capture, record into a bundle (counterpart of
``paddle_tpu/inference/aot/builder.py``).

The builder drives a real ``ContinuousBatchingPredictor`` (its engine in
recording mode) over synthetic prompts shaped to each bucket, so the
signatures in the bundle are literally those the serve loop dispatches;
every miss runs once, is captured and is recorded. What gets recorded,
per the bucket table (the reference's calibration):

- **prefill**: one program per (batch bucket, prompt bucket);
- **decode** (or **decode_sample** with ``sampling_enabled``): one
  program for every step of every request;
- **mixed**: with chunked prefill, one program per chunk bucket
  ``{page_size * 2^k <= chunk_max}``;
- **spec**: with speculative decoding, the verify program;
- **forward**: the plain model forward (logits) per prompt bucket;
- **custom**: ``add_program(name, fn, *args)`` captures any extra step
  (a captured graph holds its caller's tensors, so a warm start records
  the signature and leaves the capture to the program's owner).

``add_traffic(prompts, ...)`` serves real prompts through the recording
predictor after the bucket table (its prefix cache emptied first, as a
fresh predictor's), for signatures no bucket steers (a prefix-cache
suffix prefill). While it builds, the kernel build
directory points at the bundle's ``kernels/``, and the libraries and
Triton cache entries this process had already loaded are copied in, so a
warm start from the bundle compiles nothing.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ...kernels import _build
from ...observability import metrics as _obsm
from ...observability import tracing as _obstr
from .bundle import EngineBundle, model_fingerprint
from .engine import (InferenceEngine, _named_kv_dtype, _serve_topology,
                     wire_kernel_cache)

__all__ = ["EngineBuilder", "build_engine"]


class EngineBuilder:
    """Collects capture targets, then :meth:`build` writes the bundle.

    ``prompt_buckets`` are prompt-length buckets (the predictor's
    admission bucketing); ``batch_sizes`` the admission batch sizes to
    capture per bucket (each <= ``max_batch_size``)."""

    def __init__(self, model,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 batch_sizes: Optional[Sequence[int]] = None,
                 max_new_tokens: int = 2, capture_forward: bool = True,
                 runtime_config=None, **cb_kwargs):
        from ...framework.runtime_config import RuntimeConfig
        self.model = model
        # the default is the pure-default config: the builder pins every
        # compiled field explicitly
        self._rc = runtime_config if runtime_config is not None \
            else RuntimeConfig()
        if prompt_buckets is None:
            prompt_buckets = self._rc.prompt_buckets or (8, 16)
        self.prompt_buckets = sorted(set(int(b) for b in prompt_buckets))
        self.cb_kwargs = _named_kv_dtype(cb_kwargs)
        self.max_new_tokens = int(max_new_tokens)
        # a prefill-role bundle serves one token per request (then the KV
        # span hands off): calibration runs max_new 1, so the bundle holds
        # no decode programs that role never dispatches
        if self.cb_kwargs.get("role", self._rc.serve_role) == "prefill":
            self.max_new_tokens = 1
        self.capture_forward = bool(capture_forward)
        bmax = int(self.cb_kwargs.get("max_batch_size",
                                      self._rc.max_batch_size))
        if batch_sizes is None:
            batch_sizes, n = [], 1
            while n <= bmax:
                batch_sizes.append(n)
                n *= 2
        self.batch_sizes = sorted(set(
            int(n) for n in batch_sizes if 1 <= int(n) <= bmax))
        self._extra = []     # (name, fn, args)
        self._traffic = []   # (prompts, max_new_tokens, sampling)

    def add_program(self, name: str, fn, *example_args):
        """Queue an extra step for capture under signature
        ``("custom", name)``."""
        self._extra.append((str(name), fn, example_args))
        return self

    def add_traffic(self, prompts, max_new_tokens=2, sampling=None):
        """Queue real prompts to serve through the recording predictor
        after the bucket table (``generate``'s arguments)."""
        self._traffic.append((list(prompts), max_new_tokens, sampling))
        return self

    # ------------------------------------------------------------ build --
    def _geometry(self) -> Dict:
        g = dict(self.cb_kwargs)
        rc = self._rc
        g.setdefault("max_batch_size", rc.max_batch_size)
        g.setdefault("page_size", rc.page_size)
        g.setdefault("max_seq_len", rc.max_seq_len)
        g.setdefault("pad_token_id", 0)
        g.setdefault("eos_token_id", None)
        if rc.num_pages is not None:
            g.setdefault("num_pages", rc.num_pages)
        # program variants pinned explicitly: the manifest says what was
        # calibrated
        g.setdefault("prefill_chunk_tokens", rc.prefill_chunk_tokens)
        g.setdefault("spec_draft_tokens", rc.spec_draft_tokens)
        g.setdefault("sampling_enabled", rc.sampling_enabled)
        g.setdefault("tp_degree", rc.tp_degree)
        g.setdefault("mesh_topology", _serve_topology(g["tp_degree"]))
        g.setdefault("role", rc.serve_role)
        return g

    def effective_runtime_config(self):
        """The config the bundle encodes: the input RuntimeConfig with the
        builder's resolved geometry and bucket table folded in (hashed
        into the manifest; what a warm-started predictor rebuilds)."""
        g = self._geometry()
        return self._rc.replace(
            max_batch_size=int(g["max_batch_size"]),
            page_size=int(g["page_size"]),
            max_seq_len=int(g["max_seq_len"]),
            num_pages=g.get("num_pages"),
            prefill_chunk_tokens=int(g["prefill_chunk_tokens"]),
            spec_draft_tokens=int(g["spec_draft_tokens"]),
            sampling_enabled=bool(g["sampling_enabled"]),
            tp_degree=int(g["tp_degree"]),
            serve_role=str(g["role"]),
            prompt_buckets=tuple(self.prompt_buckets))

    def build(self, path: str, wire_cache: bool = True,
              seed: int = 0) -> Dict:
        """Calibrate, capture, record; returns the bundle manifest (the
        builder keeps ``build_seconds``, also the ``aot.build_seconds``
        gauge; the work runs inside an ``aot.build`` span)."""
        geometry = self._geometry()
        eff_rc = self.effective_runtime_config()
        buckets = {"prompt_buckets": self.prompt_buckets,
                   "batch_sizes": self.batch_sizes,
                   "max_new_tokens": self.max_new_tokens}
        t0 = time.perf_counter()
        device = self.model.device
        with _obstr.span("aot.build", parent=None, path=path,
                         prompt_buckets=str(self.prompt_buckets),
                         batch_sizes=str(self.batch_sizes),
                         config_hash=eff_rc.config_hash()[:12]) as sp:
            bundle = EngineBundle.create(
                path, model_fingerprint(self.model), geometry, buckets,
                runtime_config=eff_rc.to_dict(), device=device)
            prev = wire_kernel_cache(bundle.kernel_dir, device) \
                if wire_cache else None
            try:
                self._calibrate(bundle, geometry, eff_rc, seed, sp)
                if wire_cache:
                    bundle.add_kernels(_build.loaded_libraries(), prev[1]
                                       or str(Path(prev[0]) / "triton"))
            finally:
                if wire_cache:
                    _build.restore_build_dir(prev)
            manifest = bundle.manifest(refresh=True)
            sp.set_label(artifacts=len(manifest.get("artifacts", {})),
                         build_s=round(time.perf_counter() - t0, 3))
        self.build_seconds = time.perf_counter() - t0
        _obsm.gauge("aot.build_seconds", unit="s").set(self.build_seconds)
        return manifest

    def _calibrate(self, bundle, geometry, eff_rc, seed, sp):
        from ..predictor import ContinuousBatchingPredictor
        engine = InferenceEngine(bundle, write_back=True, recording=True)
        # the calibration predictor runs the config the manifest records
        ctor_geo = {k: v for k, v in geometry.items()
                    if k != "mesh_topology"}
        ctor_geo.setdefault("device", self.model.device)
        cb = ContinuousBatchingPredictor(self.model, engine=engine,
                                         runtime_config=eff_rc, **ctor_geo)
        rng = np.random.RandomState(seed)
        vocab = int(getattr(getattr(self.model, "config", None),
                            "vocab_size", 0) or 256)
        for pb in self.prompt_buckets:
            for n in self.batch_sizes:
                prompts = [rng.randint(2, vocab, (pb,)).tolist()
                           for _ in range(n)]
                cb.generate(prompts, max_new_tokens=self.max_new_tokens)
                sp.event("bucket", prompt_bucket=pb, batch=n)
        if geometry.get("prefill_chunk_tokens"):
            self._capture_mixed(cb, rng, vocab, sp)
        if geometry.get("spec_draft_tokens"):
            self._compile_spec_sig(cb)
            sp.event("spec", draft_tokens=int(geometry["spec_draft_tokens"]))
        for prompts, max_new, sampling in self._traffic:
            # served as by a fresh predictor: the calibration prompts'
            # cached pages would change which prefix hits it sees
            if cb.prefix_cache is not None:
                cb.prefix_cache.clear(cb.pool)
            cb.generate(prompts, max_new_tokens=max_new, sampling=sampling)
        if self.capture_forward:
            self._capture_forward(cb, engine, rng, vocab, sp)
        for name, fn, args in self._extra:
            engine.compile_fallback(("custom", name), fn, args)
            sp.event("custom", name=name)

    # ---------------------------------------------------------- capture --
    def _capture_mixed(self, cb, rng, vocab, sp):
        """Capture every ("mixed", Qb, ...) signature the serve loop can
        dispatch, one long synthetic prompt per chunk bucket Qb in
        {page * 2^k <= chunk_max}: a prompt of length chunk_max + Qb/2 + 1
        runs exactly {chunk_max, Qb} (chunk_max + 1 runs {chunk_max,
        page}). A bucket whose steering prompt cannot fit max_seq_len is
        still reachable at serve time, so it is captured directly on idle
        operands instead."""
        cm = cb._chunk_max
        qb, buckets = cb.page, []
        while qb <= cm:
            buckets.append(qb)
            qb *= 2
        driven = set()
        for qb in buckets:
            tail = 1 if qb in (cb.page, cm) else qb // 2 + 1
            length = cm + tail
            if length + self.max_new_tokens > cb.max_seq_len:
                self._capture_idle(cb, "mixed", qb)
                sp.event("mixed_bucket", q_bucket=qb, direct=True)
            elif length not in driven:   # page and cm share a prompt
                driven.add(length)
                prompt = rng.randint(2, vocab, (length,)).tolist()
                cb.generate([prompt], max_new_tokens=self.max_new_tokens)
                sp.event("mixed_bucket", q_bucket=qb, prompt_len=length)

    @staticmethod
    def _capture_idle(cb, kind, qb):
        """Capture one ("mixed" | "spec", qb, ...) signature on the
        predictor's idle operands (every slot over the trash page)."""
        meta = ((cb.B * cb.pages_per_seq,),) * 6 if cb.use_ragged else ()
        sig = (kind, qb, (cb.B, cb.pages_per_seq), meta)
        fn, args = cb._idle_program(sig)
        cb._jit_call(sig, fn, *args)

    def _compile_spec_sig(self, cb):
        """Capture the ("spec", k+1, ...) verify signature directly:
        calibration traffic cannot reliably steer the drafter, but the
        signature is dispatchable whenever any request's history matches.
        (With ``sampling_enabled`` the calibration decode ticks already
        dispatch ("decode_sample", ...).)"""
        self._capture_idle(cb, "spec", cb._spec_k + 1)

    def _capture_forward(self, cb, engine, rng, vocab, sp):
        """Capture the model's plain forward (logits) per prompt bucket:
        the surface a captured-vs-eager parity check reads."""
        for pb in self.prompt_buckets:
            ids = rng.randint(2, vocab, (1, pb)).astype(np.int64)
            engine.compile_fallback(("forward", (1, pb)), cb._raw_forward,
                                    (cb._put(ids),))
            sp.event("forward", prompt_bucket=pb)


def build_engine(model, path: str, prompt_buckets=None,
                 batch_sizes=None, max_new_tokens: int = 2,
                 wire_cache: bool = True, runtime_config=None,
                 **cb_kwargs) -> Dict:
    """One-call builder (see :class:`EngineBuilder`)."""
    return EngineBuilder(model, prompt_buckets=prompt_buckets,
                         batch_sizes=batch_sizes,
                         max_new_tokens=max_new_tokens,
                         runtime_config=runtime_config,
                         **cb_kwargs).build(path, wire_cache=wire_cache)
