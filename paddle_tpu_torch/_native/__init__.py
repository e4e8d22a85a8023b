"""ctypes binding of the port's host library (counterpart of the
reference's ``_native`` package, ``ShmChannel`` only): the
shared-memory ring that carries the DataLoader's batches from its worker
processes (``io/_worker.py``).

The library is built from ``csrc/shm_channel.cc`` at first use with the
host compiler (``g++ -O2 -std=c++17 -fPIC -pthread -shared ... -lrt``;
``$CXX`` overrides ``g++``) into the build directory of the CUDA
libraries (``kernels/_build.py``: ``paddle_tpu_torch/_build/``), named
by a hash of the source and the flags, so an edited source is rebuilt
and a stale library never loaded. A failed build raises; nothing falls
back to another transport. ``TCPStore`` and the flag library wait for
the distributed slice.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import subprocess
import threading
from pathlib import Path

from ..kernels import _build

SOURCE = _build.SRC_DIR / "shm_channel.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _build.BUILD_DIR / f"libshm_channel-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/shm_channel.cc`` unless its library is there;
    returns the library's path. Raises when the compiler fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE), "-lrt"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)     # atomic: a concurrent loader never sees half
    return path


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), every function's
    ``argtypes`` / ``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            u8p = ctypes.POINTER(ctypes.c_uint8)
            for fn, args, res in (
                    ("pd_last_error", [], ctypes.c_char_p),
                    ("pd_free", [vp], None),
                    ("pd_shm_create", [ctypes.c_char_p, i64], vp),
                    ("pd_shm_open", [ctypes.c_char_p], vp),
                    # c_char_p: a bytes argument passes its own buffer,
                    # uncopied
                    ("pd_shm_push", [vp, ctypes.c_char_p, i64,
                                     ctypes.c_int], ctypes.c_int),
                    ("pd_shm_pop", [vp, ctypes.POINTER(u8p), ctypes.c_int],
                     i64),
                    ("pd_shm_close_write", [vp], None),
                    ("pd_shm_free", [vp, ctypes.c_int], None)):
                f = getattr(lib, fn)
                f.argtypes, f.restype = args, res
            _lib = lib
        return _lib


def _err(lib) -> str:
    msg = lib.pd_last_error()
    return msg.decode() if msg else "unknown error"


class ShmChannel:
    """Bounded byte-message channel in POSIX shared memory: the owner
    (``create=True``) makes segment ``name`` of ``capacity`` ring bytes,
    other processes open it by name. ``push`` blocks while the ring is
    full, ``pop`` while it is empty; ``close_write`` lets readers drain
    it, after which ``pop`` returns None."""

    def __init__(self, name: str, capacity: int = 64 << 20,
                 create: bool = False):
        lib = load()
        self._lib = lib
        self.name = name
        self._owner = create
        if create:
            self._h = lib.pd_shm_create(name.encode(), capacity)
        else:
            self._h = lib.pd_shm_open(name.encode())
        if not self._h:
            raise RuntimeError(f"ShmChannel({name!r}): {_err(lib)}")

    def push(self, data: bytes, timeout_ms: int = 60000) -> None:
        data = bytes(data)        # no copy when it is bytes already
        rc = self._lib.pd_shm_push(self._h, data, len(data), timeout_ms)
        if rc != 0:
            raise RuntimeError(f"ShmChannel.push: {_err(self._lib)}")

    def pop(self, timeout_ms: int = 60000):
        """The next message's bytes, or None when the channel is closed
        and drained."""
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.pd_shm_pop(self._h, ctypes.byref(out), timeout_ms)
        if n == -3:
            return None
        if n < 0:
            raise TimeoutError(f"ShmChannel.pop: {_err(self._lib)}")
        data = ctypes.string_at(out, n)
        self._lib.pd_free(out)
        return data

    def push_obj(self, obj, timeout_ms: int = 60000) -> None:
        self.push(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
                  timeout_ms)

    def pop_obj(self, timeout_ms: int = 60000):
        data = self.pop(timeout_ms)
        return None if data is None else pickle.loads(data)

    def close_write(self) -> None:
        self._lib.pd_shm_close_write(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.pd_shm_free(self._h, 1 if self._owner else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except (AttributeError, OSError):
            pass
