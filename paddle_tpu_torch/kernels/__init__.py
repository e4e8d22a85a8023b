"""Hand-written Hopper kernels of the port and their plain versions.

The entries live in their modules (``norm.fused_rms_norm``,
``attention.flash_attention_bshd``, ``paged_attention.paged_attention``
/ ``paged_attention_ragged`` / ``paged_attention_varq`` /
``paged_attention_ragged_varq``, ``rope``,
``fused_optimizer.fused_update`` / ``grad_sq_norm``,
``sampling.categorical_rows`` / ``uniform64_rows``); this package
exports the shared constant and the launch counters (by kernel, and by
kernel and operand dtypes).
"""
from ._build import (NEG_INF, dtype_launch_counts, launch_counts,
                     reset_launch_counts)

__all__ = ["NEG_INF", "dtype_launch_counts", "launch_counts",
           "reset_launch_counts"]
