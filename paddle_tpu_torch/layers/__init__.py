"""User-facing layers API (python/paddle/fluid/layers parity).

Counterpart of ``paddle_tpu/layers/`` for the layer functions this slice
calls, with the reference's names and signatures.
"""

from paddle_tpu_torch.layers import math_ops  # noqa: F401
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.layers.ops import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.io import *  # noqa: F401,F403
from paddle_tpu_torch.layers.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.layers.loss import *  # noqa: F401,F403
from paddle_tpu_torch.layers.sequence import *  # noqa: F401,F403
from paddle_tpu_torch.layers.attention import *  # noqa: F401,F403
from paddle_tpu_torch.layers.metric_op import *  # noqa: F401,F403
from paddle_tpu_torch.layers.rnn import *  # noqa: F401,F403
