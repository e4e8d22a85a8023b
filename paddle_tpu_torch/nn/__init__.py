"""Counterpart of ``paddle_tpu/nn`` (only what the Llama serving path uses)."""
from . import functional  # noqa: F401
