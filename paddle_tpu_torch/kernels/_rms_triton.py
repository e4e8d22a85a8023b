"""Triton RMSNorm forward kernel. Imported only by
``norm.rms_norm_kernel`` when it launches on a CUDA tensor, so importing
the package never needs ``triton``.

Replaces: ``paddle_tpu/kernels/norm.py`` ``_rms_kernel`` (called through
``_rms_pallas``), which normalizes 256-row VMEM blocks.

Bound on the H100: memory. Per row it reads D values of x and writes D
of y with ~4 operations per value, far below the ~295 operations per
byte the card needs before compute limits it. The design moves each byte
once: one program per row holds the whole row in registers (D up to
16384 as one power-of-two block), reduces the sum of squares in f32 and
writes the scaled row straight back in ``x.dtype``; the weight vector is
re-read per row but stays in L2.
"""
from ._build import use_triton_cache

use_triton_cache()     # before triton reads TRITON_CACHE_DIR
import triton  # noqa: E402
import triton.language as tl  # noqa: E402


@triton.jit
def _rms_norm_fwd(x_ptr, w_ptr, y_ptr, D, eps, BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    keep = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=keep, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=keep, other=0.0).to(tl.float32)
    y = x * rstd * w
    tl.store(y_ptr + row * D + cols, y.to(y_ptr.dtype.element_ty), mask=keep)


def launch(x2d, w, y, eps):
    n, d = x2d.shape
    block = triton.next_power_of_2(d)
    if block > 16384:
        raise ValueError(f"rms_norm: D={d} exceeds the one-block row "
                         "limit of 16384")
    warps = 4 if block <= 1024 else (8 if block <= 4096 else 16)
    _rms_norm_fwd[(n,)](x2d, w, y, d, eps, BLOCK_D=block, num_warps=warps)
