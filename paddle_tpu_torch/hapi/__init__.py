"""High-level API (counterpart of ``paddle_tpu/hapi``): ``flops``. The
reference's ``Model``, ``summary``, callbacks and the rest are not ported
yet."""
from .flops import flops

__all__ = ["flops"]
