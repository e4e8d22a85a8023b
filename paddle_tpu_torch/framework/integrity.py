"""Artifact-integrity helpers: SHA-256 digests and atomic writes (the
port's own copy of ``paddle_tpu/framework/integrity.py``; the AOT engine
bundle, ``inference/aot/bundle.py``, writes through it).

- **Digests.** ``sha256_file`` / ``sha256_bytes`` produce the manifest
  digests; a reader that re-hashes against the manifest detects
  truncation, bitrot and partial writes instead of loading them.
- **Atomicity.** ``atomic_write_bytes`` / ``atomic_write_json`` write to a
  temp name in the destination directory and ``os.replace`` into place;
  ``replace_dir`` does the same for a fully staged directory. A crash
  mid-write never leaves a half-artifact under the final name.
- **Orphan sweep.** ``sweep_tmp`` removes THIS process's leftover temp
  files/dirs from earlier failed attempts (other pids may have writes
  in flight under their own suffix; those are never touched).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Optional

__all__ = [
    "sha256_bytes", "sha256_file", "atomic_write_bytes",
    "atomic_write_json", "replace_dir", "tmp_name", "sweep_tmp",
    "read_json",
]

_CHUNK = 1 << 20


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def tmp_name(final_path: str, kind: str = "tmp") -> str:
    """Temp sibling of `final_path`, unique to this pid: same
    filesystem (so os.replace is atomic) and sweepable by suffix."""
    d, base = os.path.split(os.path.abspath(final_path))
    return os.path.join(d, f".{kind}-{base}-{os.getpid()}")


def sweep_tmp(directory: str, kind: str = "tmp"):
    """Remove THIS process's orphaned temp files/dirs in `directory`
    (earlier failed attempts). Other pids' temps are left alone: a
    sibling rank sharing the directory may have a write in flight, and
    deleting it would turn one transient fault into a cross-process
    failure. Foreign orphans cost disk, not correctness."""
    suffix = f"-{os.getpid()}"
    prefix = f".{kind}-"
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for n in names:
        if n.startswith(prefix) and n.endswith(suffix):
            p = os.path.join(directory, n)
            try:
                if os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    os.unlink(p)
            except OSError:
                pass


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write bytes durably-atomically: temp sibling + os.replace.
    Returns the SHA-256 hex digest of `data`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = tmp_name(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return sha256_bytes(data)


def atomic_write_json(path: str, obj) -> str:
    """JSON-serialize `obj` and atomically write it; returns the
    digest of the serialized bytes."""
    return atomic_write_bytes(path, json.dumps(obj).encode())


def replace_dir(tmp_dir: str, final_dir: str,
                remove_existing: bool = True) -> str:
    """Atomically promote a fully-staged temp directory to its final
    name (the engine-bundle commit step). An
    existing final dir is removed first when `remove_existing`."""
    final_dir = os.path.abspath(final_dir)
    if remove_existing and os.path.exists(final_dir):
        shutil.rmtree(final_dir)
    os.replace(tmp_dir, final_dir)
    return final_dir


def read_json(path: str) -> Optional[dict]:
    """Best-effort JSON read: None when missing/unparseable (callers
    treat that as 'artifact absent / invalid', not an exception)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
