"""paddle_tpu_torch: the Fluid-capability framework in PyTorch for an
NVIDIA H100.

The counterpart of ``paddle_tpu`` (which stays the reference), with the
same module layout and public names: build a ``Program`` with
``layers.*`` under ``program_guard``, train it with
``optimizer.Adam(...).minimize(loss)`` (graph-level autodiff,
``backward.py``), run it with an ``Executor`` on a ``CUDAPlace`` (the
default) or a ``CPUPlace``, save it with ``io.save_inference_model``
and serve it through ``inference.create_paddle_predictor``, and serve
the Transformer through
``serving.generation.SlotDecodeSession(paged=True)``. The ops that the
JAX package runs through Pallas kernels run here through
hand-written CUDA kernels (``kernels/``, sources in ``csrc/``). This
package imports torch and never jax, and nothing of ``paddle_tpu``.
"""

from paddle_tpu_torch import ops  # noqa: F401  (registers every lowering)
from paddle_tpu_torch import flags, initializer, layers, unique_name  # noqa: F401
from paddle_tpu_torch import backward, clip, optimizer, regularizer  # noqa: F401
from paddle_tpu_torch import inference, io, nets  # noqa: F401
from paddle_tpu_torch.core.scope import Scope  # noqa: F401
from paddle_tpu_torch.core.types import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    TPUPlace,
)
from paddle_tpu_torch.executor import (  # noqa: F401
    Executor,
    global_scope,
    scope_guard,
)
from paddle_tpu_torch.framework import (  # noqa: F401
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from paddle_tpu_torch.param_attr import ParamAttr  # noqa: F401

__version__ = "0.1.0"
