"""Runnable entries of the port (counterparts of the repository's
``examples/`` scripts)."""
