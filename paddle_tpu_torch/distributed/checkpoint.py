"""Verified checkpointing (counterpart of
``paddle_tpu/distributed/checkpoint.py`` ``VerifiedCheckpointer``, its
synchronous subset).

Layout: ``<dir>/<step>/aNNNNN.bin`` (raw bytes of each tensor) and
``manifest.json`` with each array's file, shape, dtype and SHA-256, plus
the caller's metadata. A save is written into a temp sibling directory
and renamed into place, so a crash never leaves a half checkpoint under a
step name; ``verify`` re-hashes every file, and ``restore_latest`` walks
newest to oldest and returns the newest checkpoint that verifies.
``max_to_keep`` bounds the steps on disk. Saves are synchronous: the
background drain, save retries and fault injection are not ported.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_KEY_SEP = "/"
_CHUNK = 1 << 22
_logger = logging.getLogger("paddle_tpu_torch.checkpoint")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _flatten(tree: Dict, prefix: str = "", out=None) -> Dict:
    """Nested {str: tensor | array | dict} -> {'a/b/c': CPU tensor}."""
    out = {} if out is None else out
    for k, v in tree.items():
        key = f"{prefix}{_KEY_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flatten(v, key, out)
        else:
            out[key] = torch.as_tensor(v).detach().cpu().contiguous()
    return out


def _unflatten(flat: Dict) -> Dict:
    root: Dict = {}
    for key, v in flat.items():
        parts = key.split(_KEY_SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a checkpoint manifest")
    return dt


class VerifiedCheckpointer:
    """Durable checkpoint store for preemptible training (synchronous)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def steps(self):
        """Checkpoint steps on disk, ascending (unverified included)."""
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    # ------------------------------------------------------------- save --
    def save(self, step: int, state_dict: Dict,
             meta: Optional[Dict] = None) -> str:
        """Persist ``state_dict`` (nested dicts of tensors or arrays) under
        ``step``; returns the finalized directory."""
        step = int(step)
        flat = _flatten(state_dict)
        final = self._step_dir(step)
        tmp = os.path.join(self._dir, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            manifest = {"format": 1, "step": step, "meta": meta or {},
                        "arrays": {}}
            for i, (key, t) in enumerate(sorted(flat.items())):
                fname = f"a{i:05d}.bin"
                fpath = os.path.join(tmp, fname)
                with open(fpath, "wb") as f:
                    f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
                manifest["arrays"][key] = {
                    "file": fname, "sha256": _sha256_file(fpath),
                    "shape": list(t.shape),
                    "dtype": str(t.dtype).removeprefix("torch.")}
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.max_to_keep or None]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return final

    # ----------------------------------------------------------- verify --
    def verify(self, step: int) -> Tuple[bool, str]:
        """Manifest present and parseable; every array file present with
        a matching digest."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, _MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return False, f"manifest unreadable: {e}"
        for key, rec in manifest.get("arrays", {}).items():
            fpath = os.path.join(d, rec["file"])
            if not os.path.exists(fpath):
                return False, f"missing array file for {key!r}"
            if _sha256_file(fpath) != rec["sha256"]:
                return False, f"digest mismatch for {key!r}"
        return True, "ok"

    def latest_verified(self) -> Optional[int]:
        for step in reversed(self.steps()):
            if self.verify(step)[0]:
                return step
        return None

    # ---------------------------------------------------------- restore --
    def restore(self, step: int) -> Tuple[Dict, Dict]:
        """One verified checkpoint -> (nested tree of CPU tensors, meta);
        raises IOError when it does not verify."""
        ok, why = self.verify(step)
        if not ok:
            raise IOError(f"checkpoint step {step} failed verification: "
                          f"{why}")
        return self._load(step)

    def _load(self, step: int) -> Tuple[Dict, Dict]:
        d = self._step_dir(step)
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
        flat = {}
        for key, rec in manifest["arrays"].items():
            raw = np.fromfile(os.path.join(d, rec["file"]), dtype=np.uint8)
            flat[key] = torch.from_numpy(raw).view(
                _dtype(rec["dtype"])).reshape(rec["shape"])
        return _unflatten(flat), manifest.get("meta", {})

    def restore_latest(self) -> Optional[Tuple[int, Dict, Dict]]:
        """Newest verified checkpoint -> (step, tree, meta), skipping
        (and logging) the ones that fail verification; None when nothing
        usable exists."""
        for step in reversed(self.steps()):
            ok, why = self.verify(step)
            if not ok:
                _logger.warning("checkpoint step %s failed verification "
                                "(%s); falling back to the previous one",
                                step, why)
                continue
            try:
                tree, meta = self._load(step)
            except (OSError, ValueError, RuntimeError) as e:
                _logger.warning("checkpoint step %s unreadable (%s); "
                                "falling back", step, e)
                continue
            return step, tree, meta
        return None
