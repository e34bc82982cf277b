"""The comparison and logical ops of the port against the JAX package's
lowerings, one case per op type, on the CPU: ``less_than``,
``less_equal``, ``greater_than``, ``greater_equal``, ``equal``,
``not_equal`` (float and int inputs, numpy broadcasting, ties), the four
``logical_*`` (bool and int inputs), ``is_empty`` (a tensor with rows and
one without) and ``where_select`` (its gradient to X and Y too).

The harness is ``test_torch_tensor_ops.py``'s: the same program built
through the same layer in both packages (``where_select``, the IfElse
merge, with ``append_op``), equal ops, equal outputs, equal gradients.
"""

import numpy as np
import pytest

from paddle_tpu_torch.testing import fresh_state
from test_torch_tensor_ops import L, case, check_case


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


_a = np.array([[1.0, 2.0, -3.0, 0.5], [0.0, 2.0, 7.0, -1.0]], "float32")
_b = np.array([[1.0, 3.0, -3.0, 0.25]], "float32")
_i = np.array([[3, -1, 0], [2, 2, 5]], "int64")
_j = np.array([2, -1, 4], "int64")
_p = np.array([[True, False, True], [False, False, True]])
_q = np.array([[True, True, False], [False, True, True]])

CASES = {}
for _op in ("less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal"):
    CASES[_op] = case(L((lambda o: lambda l, x, y: getattr(l, o)(x, y))(
        _op)), {"x": _a, "y": _b}, grad=False)
    CASES[_op + "_int"] = case(L((lambda o: lambda l, x, y: getattr(l, o)(
        x, y))(_op)), {"x": _i, "y": _j}, grad=False)
for _op in ("logical_and", "logical_or", "logical_xor"):
    CASES[_op] = case(L((lambda o: lambda l, x, y: getattr(l, o)(x, y))(
        _op)), {"x": _p, "y": _q}, grad=False)
    CASES[_op + "_int"] = case(L((lambda o: lambda l, x, y: getattr(l, o)(
        x, y))(_op)), {"x": _i, "y": _i[::-1].copy()}, grad=False)
CASES.update({
    "logical_not": case(L(lambda l, x: l.logical_not(x)), {"x": _p},
                        grad=False),
    "is_empty": case(L(lambda l, x: l.is_empty(x)), {"x": _a}, grad=False),
    "is_empty_no_rows": case(L(lambda l, x: l.is_empty(x)),
                             {"x": np.zeros((0, 3), "float32")}, grad=False),
})


def _where_select(pkg, vs):
    blk = pkg.default_main_program().global_block()
    out = blk.create_var(name="out")
    blk.append_op(type="where_select",
                  inputs={"Cond": [vs["cond"].name], "X": [vs["x"].name],
                          "Y": [vs["y"].name]},
                  outputs={"Out": [out.name]})
    return out


CASES["where_select"] = case(
    _where_select, {"cond": np.array([[True], [False], [True]]),
                    "x": np.arange(12, dtype="float32").reshape(3, 4),
                    "y": -np.arange(12, dtype="float32").reshape(3, 4)})


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    check_case(CASES[name])


def test_every_reference_elementwise_control_flow_op_is_registered():
    """The JAX package's control_flow_ops.py table, whole."""
    from paddle_tpu.core import op_registry as j_registry
    from paddle_tpu_torch.core import op_registry as t_registry

    import paddle_tpu.ops.control_flow_ops as j_cf

    want = {t for t in j_registry.registered_ops()
            if not t.endswith("_grad")
            and j_registry.get_op_def(t).lower.__module__ == j_cf.__name__}
    assert len(want) == 13
    for t in sorted(want):
        jd, td = j_registry.get_op_def(t), t_registry.get_op_def(t)
        assert (td.inputs, td.outputs, td.attrs) == \
            (jd.inputs, jd.outputs, jd.attrs), t
        assert (td.grad is None) == (jd.grad is None), t
