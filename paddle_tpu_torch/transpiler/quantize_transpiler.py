"""Quantization-aware-training transpiler.

Counterpart of ``paddle_tpu/transpiler/quantize_transpiler.py`` (the
reference's contrib ``QuantizeTranspiler``), with its names, var names
and errors:

* ``training_transpile`` runs BEFORE ``optimizer.minimize``: it puts a
  fake quantize / dequantize pair on every float input of the
  quantizable ops, so the synthesized grad ops differentiate the
  quantized forward (the straight-through estimator).
* ``range_abs_max``'s running activation scale is a persistable state
  var that the op rewrites in-graph (OutScale aliased onto InScale).
* ``freeze_program`` strips the fake ops of an inference program and
  snaps each quantized weight to round(w / s * Q) / Q * s in the scope.
* ``convert_to_int8`` stores those weights as int8 plus a step, behind a
  ``dequantize_weight`` op, for ``io.save_inference_model``.

The weights are snapped and converted on the host with numpy, as the JAX
package does, and written back to the device the weight lived on.
"""

import numpy as np
import torch

__all__ = ["QuantizeTranspiler"]

_QUANTIZABLE_OP_TYPES = ("conv2d", "depthwise_conv2d", "mul")


def _quantized_name(name):
    return "%s.quantized" % name


def _dequantized_name(name):
    return "%s.dequantized" % name


def _scale_name(name):
    return "%s.scale" % name


def _host(val):
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _like(arr, val):
    """``arr`` as a tensor on the device ``val`` (the scope's old value)
    lives on."""
    device = val.device if isinstance(val, torch.Tensor) else "cpu"
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class QuantizeTranspiler(object):
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000):
        if activation_quantize_type not in ("abs_max", "range_abs_max"):
            raise ValueError(
                "unknown activation_quantize_type %r"
                % (activation_quantize_type,))
        if weight_quantize_type != "abs_max":
            raise ValueError(
                "weights quantize per-batch abs_max (their value IS the "
                "batch); got %r" % (weight_quantize_type,))
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.window_size = window_size

    # -- training ----------------------------------------------------------
    def training_transpile(self, program=None, startup_program=None):
        """Insert fake quant->dequant pairs on every input of the
        quantizable ops. Call BEFORE optimizer.minimize."""
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.analysis import verify_after_transpile

        program = program or framework.default_main_program()
        startup_program = (startup_program
                           or framework.default_startup_program())
        params = {p.name
                  for p in program.global_block().all_parameters()}
        for block in program.blocks:  # sub-blocks too
            self._transpile_block(block, startup_program, params)
        program._bump_version()
        verify_after_transpile(program,
                               "QuantizeTranspiler.training_transpile")
        return program

    def _transpile_block(self, block, startup_program, params):
        dequanted = {}  # var name -> dequantized var name (this block)
        idx = 0
        while idx < len(block.ops):
            op = block.ops[idx]
            if op.type not in _QUANTIZABLE_OP_TYPES:
                idx += 1
                continue
            for slot, names in list(op.inputs.items()):
                new_names = []
                for name in names:
                    var = block.var(name)
                    if str(var.dtype) not in ("float32", "float64"):
                        new_names.append(name)
                        continue
                    if name not in dequanted:
                        is_weight = name in params
                        bits = (self.weight_bits if is_weight
                                else self.activation_bits)
                        qtype = ("abs_max" if is_weight
                                 else self.activation_quantize_type)
                        idx += self._insert_quant_dequant(
                            block, startup_program, idx, name, var, bits,
                            qtype)
                        dequanted[name] = _dequantized_name(name)
                    new_names.append(dequanted[name])
                op.inputs[slot] = new_names
            idx += 1

    def _insert_quant_dequant(self, block, startup_program, idx, name, var,
                              bits, qtype):
        """Insert (at op index idx) the quantize + dequantize ops for
        `name`; returns how many ops were inserted."""
        from paddle_tpu_torch import initializer

        quant_var = block.create_var(
            name=_quantized_name(name), shape=var.shape, dtype=var.dtype)
        dequant_var = block.create_var(
            name=_dequantized_name(name), shape=var.shape, dtype=var.dtype)
        max_range = float((1 << (bits - 1)) - 1)
        if qtype == "abs_max":
            scale_var = block.create_var(
                name=_scale_name(name), shape=[1], dtype="float32")
            block.insert_op(
                idx, type="fake_quantize_abs_max",
                inputs={"X": [name]},
                outputs={"Out": [quant_var.name],
                         "OutScale": [scale_var.name]},
                attrs={"bit_length": bits})
        else:  # range_abs_max: persistable running scale, updated in-graph
            state = block.create_var(
                name="%s.state" % _scale_name(name), shape=[1],
                dtype="float32", persistable=True)
            sb = startup_program.global_block()
            if not sb.has_var(state.name):
                sv = sb.create_var(name=state.name, shape=[1],
                                   dtype="float32", persistable=True)
                initializer.ConstantInitializer(1e-3)(sv, sb)
            block.insert_op(
                idx, type="fake_quantize_range_abs_max",
                inputs={"X": [name], "InScale": [state.name]},
                # alias onto the state var: the running-stats idiom
                outputs={"Out": [quant_var.name], "OutScale": [state.name]},
                attrs={"bit_length": bits,
                       "window_size": self.window_size})
            scale_var = state
        block.insert_op(
            idx + 1, type="fake_dequantize_max_abs",
            inputs={"X": [quant_var.name], "Scale": [scale_var.name]},
            outputs={"Out": [dequant_var.name]},
            attrs={"max_range": max_range})
        return 2

    # -- deployment --------------------------------------------------------
    def freeze_program(self, program, scope=None):
        """Strip the fake quant/dequant ops and snap every quantized
        WEIGHT in `scope` onto its int grid (round(w/s*Q)/Q*s). Only
        inference programs may be frozen (the for_test clone taken before
        minimize, or a loaded inference model). Returns {weight name:
        scale}."""
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.executor import global_scope

        scope = scope or global_scope()
        block = program.global_block()
        for op in block.ops:
            role = op.attrs.get(framework.OP_ROLE_ATTR_NAME, 0)
            if role & (framework.OpRole.Backward | framework.OpRole.Optimize):
                raise ValueError(
                    "freeze_program: program contains backward/optimizer "
                    "ops; freeze the clone(for_test=True) taken before "
                    "minimize instead")
        params = {p.name for p in block.all_parameters()}
        scales = {}

        # undo the input rewiring and drop the fake ops + their dead vars
        keep = []
        dead_vars = set()
        for op in block.ops:
            if op.type.startswith("fake_quantize") or \
                    op.type.startswith("fake_dequantize"):
                dead_vars.update(op.output_arg_names())
                continue
            for slot, names in list(op.inputs.items()):
                op.inputs[slot] = [
                    n[:-len(".dequantized")] if n.endswith(".dequantized")
                    else n
                    for n in names
                ]
            keep.append(op)
        block.ops[:] = keep

        # snap weights (identified by their now-dead .quantized twins)
        q = float((1 << (self.weight_bits - 1)) - 1)
        for name in sorted(params):
            if _quantized_name(name) not in dead_vars:
                continue
            val = scope.get_value(name)
            if val is None:
                continue
            w = np.asarray(_host(val), np.float32)
            s = float(np.max(np.abs(w))) or 1e-8
            scope.set_value(name, _like(
                (np.round(w / s * q) / q * s).astype(np.float32), val))
            scales[name] = s

        for name in dead_vars:
            # the running-scale state survives (trained state an int8
            # exporter reads); pure wiring vars are dropped
            if name.endswith(".scale.state"):
                continue
            block.vars.pop(name, None)
        program._bump_version()
        return scales

    def convert_to_int8(self, program, scope=None, scales=None):
        """Rewrite a FROZEN inference program so its quantized weights are
        STORED int8: each weight ``w`` becomes an int8 persistable
        ``w.int8`` plus a per-tensor step ``w.int8_scale`` (= s/Q), and a
        ``dequantize_weight`` op at the top of the block rehydrates the
        float, exactly the grid value freeze_program snapped to.
        ``scales``: the dict freeze_program returned (recomputed from the
        snapped weights when omitted). Returns the converted names."""
        from paddle_tpu_torch.executor import global_scope

        scope = scope or global_scope()
        block = program.global_block()
        q = float((1 << (self.weight_bits - 1)) - 1)
        if scales is None:
            # snapped weights: abs-max IS the original scale s
            scales = {}
            params = {p.name for p in block.all_parameters()}
            for op in block.ops:
                if op.type not in _QUANTIZABLE_OP_TYPES:
                    continue
                for name in op.input_arg_names():
                    if name in params and name not in scales:
                        val = scope.get_value(name)
                        if val is not None:
                            scales[name] = float(
                                np.max(np.abs(_host(val)))) or 1e-8
        converted = []
        for name in sorted(scales):
            var = block.vars.get(name)
            val = scope.get_value(name)
            if var is None or val is None:
                continue
            s = scales[name]
            w = np.asarray(_host(val), np.float32)
            i8 = np.clip(np.round(w / s * q), -q - 1, q).astype(np.int8)
            int8_name = name + ".int8"
            step_name = name + ".int8_scale"
            block.create_var(name=int8_name, shape=var.shape,
                             dtype="int8", persistable=True)
            block.create_var(name=step_name, shape=[1], dtype="float32",
                             persistable=True)
            # the float weight is now PRODUCED (by dequantize_weight), not
            # persisted: save_inference_model writes the int8 twin + step
            var.persistable = False
            block.insert_op(
                0, type="dequantize_weight",
                inputs={"X": [int8_name], "Scale": [step_name]},
                outputs={"Out": [name]}, attrs={})
            scope.set_value(int8_name, _like(i8, val))
            scope.set_value(step_name,
                            _like(np.asarray([s / q], np.float32), val))
            scope.erase([name])
            converted.append(name)
        program._bump_version()
        return converted
