"""Engine bundle: the on-disk format of an AOT serving engine (counterpart
of ``paddle_tpu/inference/aot/bundle.py``).

A bundle is a directory:

    <bundle>/
      manifest.json        # fingerprints, geometry, bucket table, digests
      x<hash>.pdprog       # one program record per signature
      kernels/             # the built kernel libraries, Triton's cache

A captured CUDA graph cannot be serialized, so a bundle stores what to
capture and the binaries to capture it with: a program record names one
signature of ``ContinuousBatchingPredictor._jit_call``, and
``kernels/`` holds the ``csrc`` libraries (``lib<name>-<hash>.so``, as
``kernels/_build.py`` names them) and the Triton kernels' cache, so a
warm start runs no compiler. ``warm_start`` captures every recorded
program (``engine.py``).

``manifest.json`` carries what a loader needs to decide whether the
bundle is usable before capturing anything:

- ``fingerprint``: the bundle format, the torch and CUDA versions, the
  device platform, name and compute capability, and nvcc's version. A
  kernel library or a program is only valid where it was built: any
  mismatch rejects the whole bundle (``aot.counters["invalidations"]``).
- ``model``: hash of the model class, config and the parameter/buffer
  name+shape+dtype tree. Programs read the weights in place, so their
  VALUES may change (a checkpoint loaded in place warm-starts fine), but
  the structure must match exactly.
- ``geometry``: the predictor arguments the programs were captured
  against; ``buckets``: the calibrated bucket table.
- ``artifacts``: per program record, its file, SHA-256 digest and kind;
  ``kernels``: per file under ``kernels/``, its digest. Digests are
  verified before use; a mismatch rejects the record (or, for a kernel
  file, the bundle).

Writes go through ``framework/integrity.py``, so a crash mid-write never
leaves a torn manifest or record under its final name.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from ...framework import integrity as _integrity

__all__ = ["EngineBundle", "BundleInvalid", "runtime_fingerprint",
           "model_fingerprint", "sig_key", "MANIFEST", "FORMAT"]

MANIFEST = "manifest.json"
FORMAT = 1
_RECORD_SUFFIX = ".pdprog"


class BundleInvalid(RuntimeError):
    """The bundle must not be loaded: missing/corrupt manifest, digest
    mismatch, or a fingerprint the current runtime cannot honor. The
    ``reason`` slug is the ``invalidations`` counter's key."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"engine bundle invalid ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason
        self.detail = detail


def _nvcc_version() -> Optional[str]:
    """nvcc's version, read without running nvcc: the toolkit's
    ``version.json`` where it has one, else the release its ``cuda.h``
    declares (``CUDA_VERSION``); None without a toolkit."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    rec = _integrity.read_json(os.path.join(home, "version.json"))
    if rec is not None:
        return (rec.get("cuda_nvcc") or rec.get("cuda") or {}).get("version")
    try:
        with open(os.path.join(home, "include", "cuda.h")) as f:
            m = re.search(r"#define\s+CUDA_VERSION\s+(\d+)", f.read())
    except OSError:
        return None
    return f"cuda.h {m.group(1)}" if m else None


def runtime_fingerprint(device=None) -> Dict:
    """What a bundle's validity depends on, for programs on ``device``
    (default: CUDA when present). Compared field for field at load: ANY
    difference rejects the bundle."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    fp = {"format": FORMAT, "torch": torch.__version__,
          "cuda": torch.version.cuda, "platform": dev.type}
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(idx)
        fp.update(device=torch.cuda.get_device_name(idx),
                  sm=f"{major}.{minor}", nvcc=_nvcc_version())
    return fp


def _config_dict(config) -> Dict:
    """Stable, JSON-able view of a model config: public scalar/str/bool
    fields only, sorted."""
    if config is None:
        return {}
    src = getattr(config, "__dict__", None) or {}
    out = {}
    for k in sorted(src):
        if k.startswith("_"):
            continue
        v = src[k]
        if isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
    return out


def model_fingerprint(model) -> str:
    """SHA-256 over the model's identity: class, config, and the
    parameter/buffer name+shape+dtype tree. Weight VALUES are excluded on
    purpose: the programs read the weights in place, so a newly trained
    checkpoint of the same architecture, loaded in place, warm-starts
    from the same bundle."""
    spec = {
        "class": type(model).__name__,
        "config": _config_dict(getattr(model, "config", None)),
        "params": [(n, list(p.shape), str(p.dtype))
                   for n, p in model.named_parameters()],
        "buffers": [(n, list(b.shape), str(b.dtype))
                    for n, b in model.named_buffers()],
    }
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()


def sig_key(sig) -> str:
    """Stable manifest key for a program signature (nested tuples of
    str/int, the predictor's ``_jit_call`` sig)."""
    return repr(sig)


def _tuplify(x):
    """A JSON-decoded signature back to nested tuples."""
    return tuple(_tuplify(y) for y in x) if isinstance(x, list) else x


def _copy_new(src, dst):
    """Copy a file unless ``dst`` exists: a file there may be a library
    this process has loaded, and rewriting a mapped file in place
    corrupts it."""
    if not os.path.exists(dst):
        shutil.copy2(src, dst)
    return dst


class EngineBundle:
    """Read/write access to one bundle directory. Thread-safe for
    concurrent ``add_artifact`` write-backs."""

    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        self._lock = threading.RLock()
        self._manifest: Optional[Dict] = None

    # ---------------------------------------------------------- paths --
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST)

    @property
    def kernel_dir(self) -> str:
        """The kernel build directory of this bundle (libraries and
        Triton's cache), wired by ``engine.wire_kernel_cache``."""
        return os.path.join(self.dir, "kernels")

    def exists(self) -> bool:
        return os.path.exists(self.manifest_path)

    # -------------------------------------------------------- manifest --
    def manifest(self, refresh: bool = False) -> Dict:
        with self._lock:
            if self._manifest is None or refresh:
                m = _integrity.read_json(self.manifest_path)
                if m is None:
                    raise BundleInvalid(
                        "manifest", f"unreadable {self.manifest_path}")
                self._manifest = m
            return self._manifest

    def _write_manifest(self, manifest: Dict):
        manifest["updated"] = round(time.time(), 3)
        _integrity.atomic_write_json(self.manifest_path, manifest)
        self._manifest = manifest

    @classmethod
    def create(cls, directory: str, model_hash: str, geometry: Dict,
               buckets: Optional[Dict] = None,
               runtime_config: Optional[Dict] = None,
               device=None) -> "EngineBundle":
        """Initialize (or RESET) a bundle: fresh manifest, stale program
        records and kernel files removed. An invalidated bundle is
        re-created, never patched. ``runtime_config`` (a
        ``RuntimeConfig.to_dict()`` payload) is recorded with its
        canonical hash."""
        b = cls(directory)
        os.makedirs(b.dir, exist_ok=True)
        _integrity.sweep_tmp(b.dir)
        for n in os.listdir(b.dir):
            if n.endswith(_RECORD_SUFFIX):
                try:
                    os.unlink(os.path.join(b.dir, n))
                except OSError:
                    pass
        shutil.rmtree(b.kernel_dir, ignore_errors=True)
        manifest = {
            "format": FORMAT, "created": round(time.time(), 3),
            "fingerprint": runtime_fingerprint(device),
            "model": model_hash, "geometry": dict(geometry),
            "buckets": dict(buckets or {}), "artifacts": {}, "kernels": {},
        }
        if runtime_config is not None:
            from ...framework.runtime_config import config_hash
            manifest["runtime_config"] = dict(runtime_config)
            manifest["runtime_config_hash"] = config_hash(
                dict(runtime_config))
        b._write_manifest(manifest)
        return b

    # -------------------------------------------------------- validate --
    def validate(self, model_hash: Optional[str] = None,
                 device=None) -> Dict:
        """Fingerprint gate: raises :class:`BundleInvalid` unless this
        runtime can use the bundle: the runtime fingerprint, the model
        hash and every recorded kernel file's digest. Program records
        are verified one by one at load (``load_artifact``)."""
        m = self.manifest(refresh=True)
        fp, cur = m.get("fingerprint") or {}, runtime_fingerprint(device)
        if fp != cur:
            diff = {k: (fp.get(k), cur.get(k)) for k in set(fp) | set(cur)
                    if fp.get(k) != cur.get(k)}
            raise BundleInvalid("fingerprint", f"{diff}")
        if model_hash is not None and m.get("model") != model_hash:
            raise BundleInvalid(
                "model", f"bundle {str(m.get('model'))[:12]}... vs "
                f"current {model_hash[:12]}...")
        for rel, rec in (m.get("kernels") or {}).items():
            path = os.path.join(self.kernel_dir, rel)
            try:
                digest = _integrity.sha256_file(path)
            except OSError as e:
                raise BundleInvalid("digest", f"missing kernel file {rel}: "
                                              f"{e}")
            if digest != rec["sha256"]:
                raise BundleInvalid("digest", f"kernel file {rel} digest "
                                              "mismatch")
        return m

    # ------------------------------------------------------- artifacts --
    def artifacts(self) -> Dict[str, Dict]:
        try:
            return dict(self.manifest().get("artifacts", {}))
        except BundleInvalid:
            return {}

    def load_artifact(self, key: str):
        """The signature a program record names, digest-verified first: a
        corrupt record raises :class:`BundleInvalid` and is never
        captured. None when the bundle has no such record."""
        rec = self.artifacts().get(key)
        if rec is None:
            return None
        path = os.path.join(self.dir, rec["file"])
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise BundleInvalid("digest", f"missing artifact {key}: {e}")
        if _integrity.sha256_bytes(raw) != rec["sha256"]:
            raise BundleInvalid("digest", f"artifact {key} digest "
                                          "mismatch")
        sig = _tuplify(json.loads(raw)["sig"])
        if sig_key(sig) != key:
            raise BundleInvalid("digest", f"artifact {key} names {sig!r}")
        return sig

    def add_artifact(self, sig) -> Dict:
        """Record one program signature in the bundle (the write-back
        half of a bucket miss) and fold in kernel files built since the
        last record, atomically."""
        key = sig_key(sig)
        kind = sig[0] if isinstance(sig, tuple) and sig else "?"
        raw = json.dumps({"sig": sig, "kind": kind}).encode()
        with self._lock:
            # refresh from disk before merging: processes may share one
            # bundle. The record's file name is a function of the
            # signature, so concurrent writers of one signature converge
            m = self.manifest(refresh=True)
            arts = m.setdefault("artifacts", {})
            fname = "x" + _integrity.sha256_bytes(
                key.encode())[:16] + _RECORD_SUFFIX
            digest = _integrity.atomic_write_bytes(
                os.path.join(self.dir, fname), raw)
            arts[key] = {"file": fname, "sha256": digest, "kind": kind,
                         "bytes": len(raw)}
            self._record_kernels(m)
            self._write_manifest(m)
            return arts[key]

    # --------------------------------------------------------- kernels --
    def add_kernels(self, libraries: Dict[str, str],
                    triton_dir: Optional[str] = None):
        """Copy kernel files into ``kernels/``: the loaded libraries
        ({name: path}) and a Triton cache directory's entries, each only
        where missing (never over a file this process may have mapped);
        then record every kernel file's digest."""
        os.makedirs(self.kernel_dir, exist_ok=True)
        for path in libraries.values():
            dst = os.path.join(self.kernel_dir, os.path.basename(path))
            if not os.path.exists(dst):
                shutil.copy2(path, dst)
        tdst = os.path.join(self.kernel_dir, "triton")
        if triton_dir and os.path.isdir(triton_dir) \
                and os.path.abspath(triton_dir) != os.path.abspath(tdst):
            shutil.copytree(triton_dir, tdst, dirs_exist_ok=True,
                            copy_function=_copy_new)
        with self._lock:
            m = self.manifest(refresh=True)
            self._record_kernels(m)
            self._write_manifest(m)

    def _record_kernels(self, m: Dict):
        """Record the digest of every library and Triton cache file under
        ``kernels/`` that the manifest does not list yet."""
        rec = m.setdefault("kernels", {})
        root = Path(self.kernel_dir)
        if not root.is_dir():
            return
        files = [p for p in root.glob("lib*.so")] + \
            [p for p in (root / "triton").rglob("*") if p.is_file()]
        for p in sorted(files):
            rel = str(p.relative_to(root))
            if rel not in rec and not p.name.startswith("."):
                rec[rel] = {"sha256": _integrity.sha256_file(str(p)),
                            "bytes": p.stat().st_size}

    def set_geometry(self, geometry: Dict):
        with self._lock:
            m = self.manifest()
            m["geometry"] = dict(geometry)
            self._write_manifest(m)
