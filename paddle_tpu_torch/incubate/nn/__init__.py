"""Counterpart of ``paddle_tpu/incubate/nn`` (what Llama serving uses)."""
from . import functional  # noqa: F401
