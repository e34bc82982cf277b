"""Carry weights and training state into the port.

``params_from_numpy(program, scope, arrays, device)`` writes every
parameter of ``program`` into ``scope`` as a tensor on ``device``, from a
mapping of parameter name to array (for instance read out of the JAX
package's scope with ``np.asarray(scope.get_value(name))``).
``persistables_from_numpy`` does the same for every persistable variable
the program's ops read, optimizer accumulators and learning rate
included, so a JAX training run continues in the port.
``draft_params_from_numpy`` carries the speculative draft decoder's own
parameters (``draft_dec_*``, ``draft_final*``, ``draft_proj_logits*``),
which no training program names, so that both packages' model drafters
propose the same tokens. Both packages mint the same names
(optimizer.py:68 for accumulators), so this is a lookup; a missing name
or a shape that differs raises.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.types import device_dtype


def _carry(variables, scope, arrays, device, who):
    device = torch.device(device)
    for var in variables:
        if var.name not in arrays:
            raise KeyError("%s: no array for %r" % (who, var.name))
        arr = np.asarray(arrays[var.name])
        if tuple(arr.shape) != tuple(var.shape):
            raise ValueError(
                "%s: %r has shape %s in the program but %s in the arrays"
                % (who, var.name, tuple(var.shape), tuple(arr.shape)))
        scope.set_value(var.name, torch.from_numpy(np.array(arr)).to(
            dtype=device_dtype(var.dtype), device=device))


def params_from_numpy(program, scope, arrays, device):
    _carry(program.global_block().all_parameters(), scope, arrays, device,
           "params_from_numpy")


def persistables_from_numpy(program, scope, arrays, device):
    """Every persistable variable that an op of ``program`` reads or
    writes: parameters, optimizer accumulators, the learning rate."""
    block = program.global_block()
    used = {n for op in block.ops
            for n in op.input_arg_names() + op.output_arg_names()}
    _carry([v for v in block.vars.values() if v.persistable
            and v.name in used], scope, arrays, device,
           "persistables_from_numpy")


def draft_params_from_numpy(scope, arrays, device, num_slots=1,
                            **draft_cfg):
    """The draft decoder's own parameters, every ``draft_*`` parameter of
    ``models.transformer.build_draft_decoder(num_slots, **draft_cfg)``'s
    step program, from ``arrays`` into ``scope``. Run it before the
    session is built: ``DraftModelDrafter`` initialises only the
    parameters its scope lacks."""
    from paddle_tpu_torch.models import transformer

    step = transformer.build_draft_decoder(num_slots, **draft_cfg)[1]
    _carry([p for p in step.global_block().all_parameters()
            if p.name.startswith("draft_")], scope, arrays, device,
           "draft_params_from_numpy")
