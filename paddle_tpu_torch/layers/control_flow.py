"""Control-flow layers: the comparisons, increment, is_empty and the
rank table (lod_rank_table, reorder_lod_tensor_by_rank).

Counterpart of ``paddle_tpu/layers/control_flow.py`` for these layers
(tensor arrays and the sub-block constructs are still to port).
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "increment", "is_empty", "lod_rank_table",
           "reorder_lod_tensor_by_rank"]


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


class RankTable(object):
    """A lod_rank_table's result: ``index`` (the batch order, by
    descending length, ties stable) and ``length`` (the sorted lengths),
    int64 Variables computed at run time."""

    def __init__(self, index, length):
        self.index = index
        self.length = length


def lod_rank_table(x=None, level=0, lengths=None):
    """Rank sequences by descending length (control_flow.py:819). The
    padded layout carries lengths as a tensor: pass ``lengths`` ([batch]
    or [batch, 1] int); ``x`` and ``level`` (which must be 0) are kept
    for the reference's signature."""
    if lengths is None:
        raise ValueError(
            "lod_rank_table needs lengths= (the dense-padded design "
            "carries sequence lengths as an explicit tensor; see "
            "docs/LOD_DESIGN.md)")
    if level != 0:
        raise ValueError("only level=0 is supported on device")
    helper = LayerHelper("lod_rank_table")
    index = helper.create_variable_for_type_inference("int64")
    sorted_len = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="lod_rank_table",
        inputs={"Length": [lengths]},
        outputs={"Index": [index], "SortedLength": [sorted_len]})
    return RankTable(index, sorted_len)


def reorder_lod_tensor_by_rank(x, rank_table):
    """``x``'s batch dimension in the rank table's order
    (control_flow.py:882); the gradient scatters back through the
    permutation."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="reorder_lod_tensor_by_rank",
        inputs={"X": [x], "RankIndex": [rank_table.index]},
        outputs={"Out": [out]})
    return out
