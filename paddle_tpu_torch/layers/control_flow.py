"""Control-flow layers: the comparisons, increment and is_empty.

Counterpart of ``paddle_tpu/layers/control_flow.py`` for its elementwise
layers (tensor arrays and the sub-block constructs are A11's).
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "increment", "is_empty"]


def _compare(op_type):
    def fn(x, y, cond=None, **kwargs):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        return cond

    fn.__name__ = op_type
    return fn


less_than = _compare("less_than")
less_equal = _compare("less_equal")
greater_than = _compare("greater_than")
greater_equal = _compare("greater_equal")
equal = _compare("equal")
not_equal = _compare("not_equal")


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool",
                                                         stop_gradient=True)
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond
