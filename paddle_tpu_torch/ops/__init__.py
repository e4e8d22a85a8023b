"""Counterpart of ``paddle_tpu/ops`` (``manipulation`` only so far: what
the vision models call)."""
from . import manipulation  # noqa: F401
