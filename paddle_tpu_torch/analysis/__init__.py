"""Program analysis (counterpart of ``paddle_tpu/analysis/``): the
structural verifier with its diagnostics, and the bucket ladder the
serving session sizes its COW programs with.

``check_program`` raises :class:`ProgramVerifyError` at a severity gate;
``verify`` names the verifier module, as in the JAX package
(``verify_program`` is its bare pass function)."""

from paddle_tpu_torch.analysis.diagnostics import (  # noqa: F401
    Diagnostic,
    ProgramVerifyError,
    format_diagnostics,
)
from paddle_tpu_torch.analysis.lint import suggest_buckets  # noqa: F401
from paddle_tpu_torch.analysis.verify import (  # noqa: F401
    check_program,
    verify_after_transpile,
)
from paddle_tpu_torch.analysis.verify import verify as verify_program  # noqa: F401
from paddle_tpu_torch.analysis import verify  # noqa: F401
from paddle_tpu_torch.analysis import diagnostics  # noqa: F401

__all__ = [
    "Diagnostic",
    "ProgramVerifyError",
    "format_diagnostics",
    "verify_program",
    "check_program",
    "verify_after_transpile",
    "suggest_buckets",
]
