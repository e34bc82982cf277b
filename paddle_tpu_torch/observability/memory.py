"""Out-of-memory classification.

Counterpart of ``paddle_tpu/observability/memory.py``'s
``MemoryExhaustedError`` and ``is_oom`` (the retry policy's veto: an
allocator exhaustion is deterministic for a given program and batch, so
retrying replays the same death). ``torch.cuda.OutOfMemoryError`` counts
as an OOM here beside the JAX package's markers. The live-buffer ledger,
the M001 diagnostic and the dump enrichment are not ported yet
(ROADMAP.md A9).
"""

__all__ = ["MemoryExhaustedError", "is_oom"]

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM when allocating", "failed to allocate")


class MemoryExhaustedError(RuntimeError):
    """An allocator-exhaustion failure carrying forensics in
    ``.diagnostic`` (None until the ledger is ported). The message keeps
    the original allocator text."""

    def __init__(self, message, diagnostic=None):
        super(MemoryExhaustedError, self).__init__(message)
        self.diagnostic = diagnostic


def is_oom(exc):
    """True for allocator-exhaustion failures, which retrying cannot
    cure."""
    if isinstance(exc, (MemoryExhaustedError, MemoryError)):
        return True
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)
