"""Carry weights into the port.

``params_from_numpy(program, scope, arrays, device)`` writes every
parameter of ``program`` into ``scope`` as a tensor on ``device``, from a
mapping of parameter name to array (for instance read out of the JAX
package's scope with ``np.asarray(scope.get_value(name))``). Both
packages mint the same parameter names, so this is a lookup; a missing
name or a shape that differs raises.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.types import device_dtype


def params_from_numpy(program, scope, arrays, device):
    device = torch.device(device)
    for param in program.global_block().all_parameters():
        if param.name not in arrays:
            raise KeyError("params_from_numpy: no array for parameter %r"
                           % param.name)
        arr = np.asarray(arrays[param.name])
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                "params_from_numpy: %r has shape %s in the program but %s "
                "in the arrays" % (param.name, tuple(param.shape),
                                   tuple(arr.shape)))
        scope.set_value(param.name, torch.from_numpy(
            np.array(arr)).to(dtype=device_dtype(param.dtype),
                                          device=device))
