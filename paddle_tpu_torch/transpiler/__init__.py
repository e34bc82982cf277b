"""Graph-to-graph transpilers (python/paddle/fluid/transpiler parity).

Counterpart of ``paddle_tpu/transpiler/`` for ``InferenceTranspiler``.
"""

from paddle_tpu_torch.transpiler.inference_transpiler import (  # noqa: F401
    InferenceTranspiler,
)
