"""Graph-to-graph transpilers (python/paddle/fluid/transpiler parity).

Counterpart of ``paddle_tpu/transpiler/`` for ``InferenceTranspiler``,
``QuantizeTranspiler`` and the bf16 AMP rewrite (``rewrite_program_amp``,
``amp_guard``).
"""

from paddle_tpu_torch.transpiler.amp_transpiler import (  # noqa: F401
    AMP_BLACK_LIST,
    AMP_WHITE_LIST,
    amp_guard,
    rewrite_program_amp,
)
from paddle_tpu_torch.transpiler.inference_transpiler import (  # noqa: F401
    InferenceTranspiler,
)
from paddle_tpu_torch.transpiler.quantize_transpiler import (  # noqa: F401
    QuantizeTranspiler,
)
