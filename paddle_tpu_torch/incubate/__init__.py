"""Counterpart of ``paddle_tpu/incubate`` (what Llama serving uses)."""
