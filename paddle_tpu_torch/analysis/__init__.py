"""Program analysis helpers (counterpart of ``paddle_tpu/analysis/``):
so far only the bucket ladder the serving session sizes its COW
programs with."""

from paddle_tpu_torch.analysis.lint import suggest_buckets  # noqa: F401
