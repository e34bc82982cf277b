"""Typed serving failures.

Counterpart of the error classes of ``paddle_tpu/serving/server.py``; the
batching server itself comes with a later slice (ROADMAP.md A8).
"""


class ServingError(RuntimeError):
    """Base of the typed serving failures."""
