"""Stdlib helpers of the port (``tbwriter``: the TensorBoard event-file
writer the observability exporters use)."""
