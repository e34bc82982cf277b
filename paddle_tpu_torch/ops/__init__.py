"""Operator definitions: schema + torch lowering per op family.

Counterpart of ``paddle_tpu/ops/``. Importing this package registers
every op the port carries so far; each lowering is a plain function on
torch tensors, and the attention and recurrent ops call the hand-written
kernels in ``paddle_tpu_torch/kernels/``.
"""

from paddle_tpu_torch.ops import math_ops  # noqa: F401
from paddle_tpu_torch.ops import tensor_ops  # noqa: F401
from paddle_tpu_torch.ops import activation_ops  # noqa: F401
from paddle_tpu_torch.ops import random_ops  # noqa: F401
from paddle_tpu_torch.ops import io_ops  # noqa: F401
from paddle_tpu_torch.ops import loss_ops  # noqa: F401
from paddle_tpu_torch.ops import nn_ops  # noqa: F401
from paddle_tpu_torch.ops import control_flow_ops  # noqa: F401
from paddle_tpu_torch.ops import subblock_ops  # noqa: F401
from paddle_tpu_torch.ops import attention_ops  # noqa: F401
from paddle_tpu_torch.ops import sequence_ops  # noqa: F401
from paddle_tpu_torch.ops import sampling_ops  # noqa: F401
from paddle_tpu_torch.ops import beam_search_ops  # noqa: F401
from paddle_tpu_torch.ops import speculative_ops  # noqa: F401
from paddle_tpu_torch.ops import optimizer_ops  # noqa: F401
from paddle_tpu_torch.ops import metric_ops  # noqa: F401
from paddle_tpu_torch.ops import rnn_ops  # noqa: F401
from paddle_tpu_torch.ops import seq2seq_ops  # noqa: F401
from paddle_tpu_torch.ops import fused_ops  # noqa: F401
from paddle_tpu_torch.ops import moe_ops  # noqa: F401
from paddle_tpu_torch.ops import detection_ops  # noqa: F401
from paddle_tpu_torch.ops import crf_ops  # noqa: F401
from paddle_tpu_torch.ops import ctc_ops  # noqa: F401
from paddle_tpu_torch.ops import quantize_ops  # noqa: F401
from paddle_tpu_torch.ops import vision_ops  # noqa: F401
