"""Build and bind the port's CUDA kernels (role of
``paddle_tpu/kernels/_common.py``).

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into the build directory and loaded with ``ctypes``. The build
directory is ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``),
or ``$PADDLE_TPU_TORCH_BUILD_DIR``; ``set_build_dir`` redirects it (the
AOT engine points it at a bundle, which then carries the libraries).
Triton's cache lives in its ``triton/`` subdirectory unless
``TRITON_CACHE_DIR`` says otherwise, so the Triton kernels travel with
the CUDA libraries. ``build_stats["nvcc"]`` counts the nvcc runs of
this process. The library file name carries a hash of the
source, of the headers beside it and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded. The sources
expose a plain C interface (no ``torch/extension.h``): every entry
returns ``cudaGetLastError()`` and :func:`check` raises when that is
not 0.

Also here: the shared ``NEG_INF`` constant and the per-kernel launch
counters that show a run really went through the kernels, with beside
them the launches per (kernel, q dtype, KV dtype) instance
(``dtype_launch_counts``: which instance a run went through). A
captured CUDA graph runs no Python when it is replayed, so the AOT
engine records the counters' change over each capture
(``launch_counts_since``), puts them back (a capture launches nothing)
and adds that change at every replay (``add_launch_counts``).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

NEG_INF = -1e30

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = Path(os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
                 or _PKG / "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# every source under csrc/ with a C entry (the headers are included)
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "ragged_decode",
           "paged_varq", "fused_optimizer", "sampling")

# launches per kernel name; a wrapper adds one where it launches its
# kernel and nowhere else
launch_counts = {"rms_norm": 0, "layer_norm": 0, "flash_fwd": 0,
                 "flash_bwd_dkdv": 0, "flash_bwd_dq": 0, "paged_decode": 0,
                 "ragged_decode": 0, "paged_varq": 0, "fused_update": 0,
                 "grad_sq_norm": 0, "categorical_rows": 0,
                 "uniform64_rows": 0}


# launches per (kernel, q dtype, KV dtype), the dtypes' names as
# "bfloat16"; a kernel with one operand dtype counts it twice
dtype_launch_counts = collections.Counter()


def _dtype_name(dt) -> str:
    return str(dt).rsplit(".", 1)[-1]


def count_launch(name: str, dtype=None, kv_dtype=None) -> None:
    """One launch of kernel ``name``; with ``dtype`` (q's torch dtype)
    also one of its (``dtype``, ``kv_dtype`` or ``dtype``) instance."""
    launch_counts[name] += 1
    if dtype is not None:
        kv = dtype if kv_dtype is None else kv_dtype
        dtype_launch_counts[(name, _dtype_name(dtype), _dtype_name(kv))] += 1


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    dtype_launch_counts.clear()


def snapshot_launch_counts() -> tuple:
    """Copies of both counters, for ``launch_counts_since`` and
    ``restore_launch_counts``."""
    return dict(launch_counts), dict(dtype_launch_counts)


def launch_counts_since(before: tuple) -> tuple:
    """The launches counted since ``before`` (a
    ``snapshot_launch_counts()``): ({kernel: n}, {(kernel, q dtype, KV
    dtype): n}), zeros left out."""
    names, dts = before
    return ({k: n - names[k] for k, n in launch_counts.items()
             if n != names[k]},
            {k: n - dts.get(k, 0) for k, n in dtype_launch_counts.items()
             if n != dts.get(k, 0)})


def restore_launch_counts(before: tuple) -> None:
    launch_counts.update(before[0])
    dtype_launch_counts.clear()
    dtype_launch_counts.update(before[1])


def add_launch_counts(delta: tuple) -> None:
    """Add a ``launch_counts_since`` result to both counters."""
    for k, n in delta[0].items():
        launch_counts[k] += n
    for k, n in delta[1].items():
        dtype_launch_counts[k] += n


# nvcc runs of this process (a warm start from a bundle runs none)
build_stats = {"nvcc": 0}


def set_build_dir(path) -> tuple:
    """Point the build directory, and Triton's cache under it, at
    ``path``; returns the previous (build directory, Triton cache
    directory or None). Libraries already loaded stay loaded."""
    global BUILD_DIR
    prev = (BUILD_DIR, os.environ.get("TRITON_CACHE_DIR"))
    BUILD_DIR = Path(path)
    os.environ["TRITON_CACHE_DIR"] = str(BUILD_DIR / "triton")
    return prev


def restore_build_dir(prev: tuple) -> None:
    """Undo ``set_build_dir`` with the pair it returned."""
    global BUILD_DIR
    BUILD_DIR = Path(prev[0])
    if prev[1] is None:
        os.environ.pop("TRITON_CACHE_DIR", None)
    else:
        os.environ["TRITON_CACHE_DIR"] = prev[1]


def use_triton_cache() -> None:
    """Triton's cache under the build directory, unless
    ``TRITON_CACHE_DIR`` is set (called before a Triton kernel's first
    compile)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of ``<name>.cu``, of every
    header in ``SRC_DIR`` (``*.cuh``, ``*.h``) it may include, and of the
    flags: an edited header rebuilds each source beside it."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")) + sorted(SRC_DIR.glob("*.h")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path):
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(SRC_DIR / f"{name}.cu")]


def build(names) -> dict:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        build_stats["nvcc"] += 1
        procs[n] = (subprocess.Popen(_nvcc_cmd(n, tmp),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])     # atomic: readers never see half
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


_libs = {}
_lib_paths = {}
_lock = threading.Lock()


def loaded_libraries() -> dict:
    """{source name: path} of every library this process loaded."""
    with _lock:
        return dict(_lib_paths)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built if needed), with
    explicit ``argtypes``/``restype`` set from ``signatures``
    ({function: [ctypes types]}); every entry returns an int error."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
            _lib_paths[name] = path
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch is
    otherwise silent until the next synchronizing call)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
