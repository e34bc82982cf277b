"""Hand-written CUDA kernels for the ops whose JAX counterparts are Pallas
kernels, each beside its plain PyTorch version.

Counterpart of ``paddle_tpu/kernels/``, plus the port's own kernels:
threefry (``threefry.py``: jax's random stream, which XLA fuses for the
JAX package) and the detection ops' greedy loops (``detection.py``:
``greedy_nms`` and ``det_match``, ``lax.fori_loop``s inside the JAX
package's executable). ``build`` compiles
``paddle_tpu_torch/csrc/*.cu`` at first use; a wrapper runs the plain
version for a CPU tensor and launches its kernel for a CUDA tensor.
``KERNELS`` maps each kernel's name to its launch handle (with its
launch count).
"""

from paddle_tpu_torch.kernels.flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DKV_BF16,
    FLASH_BWD_DQ,
    FLASH_BWD_DQ_BF16,
    FLASH_FWD,
    FLASH_FWD_BF16,
)
from paddle_tpu_torch.kernels.detection import DET_MATCH, GREEDY_NMS
from paddle_tpu_torch.kernels.gru_cell import GRU_CELL
from paddle_tpu_torch.kernels.lstm_cell import LSTM_CELL
from paddle_tpu_torch.kernels.paged_attention import (
    PAGED_DECODE,
    TREE_DECODE,
)
from paddle_tpu_torch.kernels.threefry import THREEFRY

KERNELS = {"flash_fwd": FLASH_FWD, "flash_bwd_dkv": FLASH_BWD_DKV,
           "flash_bwd_dq": FLASH_BWD_DQ, "flash_fwd_bf16": FLASH_FWD_BF16,
           "flash_bwd_dkv_bf16": FLASH_BWD_DKV_BF16,
           "flash_bwd_dq_bf16": FLASH_BWD_DQ_BF16,
           "paged_decode": PAGED_DECODE,
           "tree_decode": TREE_DECODE, "lstm_cell": LSTM_CELL,
           "gru_cell": GRU_CELL, "threefry": THREEFRY,
           "greedy_nms": GREEDY_NMS, "det_match": DET_MATCH}
