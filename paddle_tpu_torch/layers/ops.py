"""Thin layer wrappers generated from the op schemas.

Counterpart of ``paddle_tpu/layers/ops.py`` (layer_function_generator.py
role) for the single-input, single-output ops: the activations, plus
``cumsum``, ``clip``, ``clip_by_norm`` and ``maxout``. Keyword arguments
that name one of the op's attrs become that attr. Also the random
layers ``uniform_random``, ``gaussian_random``, ``sampling_id`` and the
two ``*_batch_size_like`` draws, the ``logical_*`` layers and ``fill``.
"""

from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.layer_helper import LayerHelper

_UNARY_ACTIVATIONS = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "tanh",
    "tanh_shrink",
    "softshrink",
    "sqrt",
    "rsqrt",
    "abs",
    "ceil",
    "floor",
    "cos",
    "sin",
    "round",
    "reciprocal",
    "log",
    "square",
    "softplus",
    "softsign",
    "relu",
    "relu6",
    "gelu",
    "elu",
    "leaky_relu",
    "soft_relu",
    "brelu",
    "pow",
    "stanh",
    "hard_sigmoid",
    "hard_shrink",
    "thresholded_relu",
    "swish",
    "sign",
    "log_softmax",
]

_UNARY = list(_UNARY_ACTIVATIONS) + ["cumsum", "clip", "clip_by_norm",
                                     "maxout"]
__all__ = _UNARY + ["uniform_random", "gaussian_random", "sampling_id",
                    "gaussian_random_batch_size_like",
                    "uniform_random_batch_size_like"]


def _make_unary(op_type):
    opdef = op_registry.get_op_def(op_type)

    def layer_fn(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        attrs = {k: kwargs[k] for k in opdef.attrs if k in kwargs}
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer_fn.__name__ = op_type
    layer_fn.__doc__ = "Generated layer for operator %r." % op_type
    return layer_fn


for _name in _UNARY:
    globals()[_name] = _make_unary(_name)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="uniform_random",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "min": min, "max": max,
               "seed": seed},
    )
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gaussian_random",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "mean": mean,
               "std": std, "seed": seed},
    )
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="sampling_id",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"min": min, "max": max, "seed": seed},
    )
    return out


def _make_batch_size_like(op_type, extra):
    def layer_fn(input, shape, input_dim_idx=0, output_dim_idx=0,
                 dtype="float32", name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype)
        attrs = {"shape": list(shape), "input_dim_idx": input_dim_idx,
                 "output_dim_idx": output_dim_idx, "dtype": dtype}
        for k, dv in extra.items():
            attrs[k] = kwargs.get(k, dv)
        helper.append_op(type=op_type, inputs={"Input": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer_fn.__name__ = op_type
    layer_fn.__doc__ = ("Generated layer for operator %r: the output's "
                        "shape follows the input's batch dimension."
                        % op_type)
    return layer_fn


gaussian_random_batch_size_like = _make_batch_size_like(
    "gaussian_random_batch_size_like", {"mean": 0.0, "std": 1.0, "seed": 0})
uniform_random_batch_size_like = _make_batch_size_like(
    "uniform_random_batch_size_like", {"min": -1.0, "max": 1.0, "seed": 0})


def _make_binary_logical(op_type):
    def layer_fn(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference("bool")
        inputs = {"X": [x]}
        if y is not None:
            inputs["Y"] = [y]
        helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
        return out

    layer_fn.__name__ = op_type
    return layer_fn


logical_and = _make_binary_logical("logical_and")
logical_or = _make_binary_logical("logical_or")
logical_xor = _make_binary_logical("logical_xor")
logical_not = _make_binary_logical("logical_not")


def fill(shape, value, dtype="float32", name=None):
    """Materialize an explicit value list (fill_op.cc)."""
    helper = LayerHelper("fill", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "value": [float(v) for v in value],
               "dtype": dtype},
    )
    return out


__all__ += ["logical_and", "logical_or", "logical_xor", "logical_not",
            "fill"]
