"""Inference transpiler: fold batch_norm into the conv before it.

Counterpart of ``paddle_tpu/transpiler/inference_transpiler.py``
(python/paddle/fluid/transpiler/inference_transpiler.py fuse_batch_norm).
Given ``conv2d -> (elementwise_add bias ->) batch_norm`` the batch norm's
affine map is folded into the conv filter and bias:

    a = scale / sqrt(variance + eps)
    W' = W * a[:, None, None, None]
    b' = (b - mean) * a + bn_bias

The batch_norm op and its parameters leave the program, and the readers
of its output read the conv's (or the bias add's) instead. The folded
values are computed in torch on the device the scope holds them on and
written back into the scope.
"""

import torch

__all__ = ["InferenceTranspiler"]


class InferenceTranspiler(object):
    def transpile(self, program, scope=None, place=None):
        """Fold the conv + batch_norm pairs of ``program`` (in place),
        updating the values in ``scope`` (the global scope by default)."""
        if scope is None:
            from paddle_tpu_torch.executor import global_scope

            scope = global_scope()
        block = program.global_block()

        i = 0
        while i < len(block.ops) - 1:
            op = block.ops[i]
            if op.type != "conv2d":
                i += 1
                continue
            conv_out = op.output("Output")[0]
            j = i + 1
            bias_op = None
            nxt = block.ops[j]
            if (nxt.type == "elementwise_add" and nxt.input("X")
                    and nxt.input("X")[0] == conv_out
                    and j + 1 < len(block.ops)
                    and self._is_parameter(block, nxt.input("Y"))):
                # only a parameter Y is a bias; a residual add (Y an
                # activation) is not folded into
                bias_op = nxt
                j += 1
                nxt = block.ops[j]
            if nxt.type != "batch_norm":
                i += 1
                continue
            expect = bias_op.output("Out")[0] if bias_op else conv_out
            if nxt.input("X")[0] != expect:
                i += 1
                continue
            self._fold(block, scope, op, bias_op, nxt, j)
            i += 1
        program._bump_version()
        from paddle_tpu_torch.analysis import verify_after_transpile

        verify_after_transpile(program, "InferenceTranspiler")
        return program

    @staticmethod
    def _is_parameter(block, names):
        from paddle_tpu_torch.framework import Parameter

        return bool(names) and isinstance(block.vars.get(names[0]),
                                          Parameter)

    def _fold(self, block, scope, conv_op, bias_op, bn_op, bn_idx):
        eps = bn_op.attr("epsilon") if bn_op.has_attr("epsilon") else 1e-5
        w_name = conv_op.input("Filter")[0]
        w = _tensor(scope.get_value(w_name))

        def value(slot):
            return _tensor(scope.get_value(bn_op.input(slot)[0])).to(
                w.device)

        scale, bn_bias = value("Scale"), value("Bias")
        mean, var = value("Mean"), value("Variance")
        a = scale / torch.sqrt(var + eps)
        scope.set_value(w_name, (w * a[:, None, None, None]).to(w.dtype))

        if bias_op is not None:
            b_name = bias_op.input("Y")[0]
            b_old = _tensor(scope.get_value(b_name))
            b = b_old.reshape(-1).to(w.device)
            new_b = ((b - mean) * a + bn_bias).to(b_old.dtype)
            scope.set_value(b_name, new_b.reshape(b_old.shape))
            out_name = bias_op.output("Out")[0]
        else:
            # the batch norm's shift becomes a new bias parameter + add
            b_name = w_name + ".bn_fused_bias"
            new_b = ((0.0 - mean) * a + bn_bias).to(w.dtype)
            block.create_parameter(name=b_name, shape=[int(new_b.shape[0])],
                                   dtype=block.var(w_name).dtype)
            scope.set_value(b_name, new_b)
            out_name = bn_op.output("Y")[0]
            block.insert_op(
                bn_idx, "elementwise_add",
                inputs={"X": [conv_op.output("Output")[0]], "Y": [b_name]},
                outputs={"Out": [out_name]}, attrs={"axis": 1})
            bn_idx += 1

        bn_out = bn_op.output("Y")[0]
        # drop the batch norm and point its readers at the folded output
        block.remove_op(bn_idx)
        if bias_op is not None and bn_out != out_name:
            for later in block.ops:
                for slot, names in list(later.inputs.items()):
                    later.inputs[slot] = [out_name if n == bn_out else n
                                          for n in names]
        # its parameters leave the program, so saving skips them
        for slot in ("Scale", "Bias", "Mean", "Variance"):
            block.vars.pop(bn_op.input(slot)[0], None)


def _tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
