"""``lrn`` of the port against the JAX package's, on the CPU.

The op is lrn_op.cc as the JAX package lowers it, not
``torch.nn.LocalResponseNorm``: ``alpha`` multiplies the window's sum of
squares undivided by ``n``, and channel c's window is
``[c - (n-1)//2, c + n - 1 - (n-1)//2]``, one more channel above than
below for an even ``n``. Each case builds ``layers.lrn`` in both
packages (equal ops, attrs and names), compares ``Out`` and ``MidOut``
and the gradient of X (``test_torch_tensor_ops.py``'s harness, rtol
1e-5), at odd and even ``n``, ``n`` 1 and ``n`` above the channel count;
a numpy loop over the window holds the port's formula on its own.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.testing import fresh_state
from test_torch_tensor_ops import _r, case, check_case


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _lrn(n, k=1.0, alpha=1e-4, beta=0.75, mid=False):
    def build(pkg, vs):
        out = pkg.layers.lrn(vs["x"], n=n, k=k, alpha=alpha, beta=beta)
        if not mid:
            return out
        op = pkg.default_main_program().global_block().ops[-1]
        blk = pkg.default_main_program().global_block()
        return [out, blk.var(op.output("MidOut")[0])]
    return build


# large values, so alpha * window sum is far from 0 against k
_X = _r(3, 2, 7, 3, 4, lo=-30.0, hi=30.0)

CASES = {
    "n5": case(_lrn(5), {"x": _X}),
    "n4_even": case(_lrn(4, k=2.0, alpha=1e-3, beta=0.5), {"x": _X}),
    "n2_even": case(_lrn(2, alpha=1e-2), {"x": _X}),
    "n1": case(_lrn(1, alpha=1e-2), {"x": _X}),
    "n9_above_channels": case(_lrn(9, alpha=1e-3), {"x": _X}),
    "n6_mid_out": case(_lrn(6, alpha=1e-3, mid=True), {"x": _X},
                       weighted=[0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lrn_matches_jax(name):
    check_case(CASES[name])


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_lrn_window_is_lrn_op_cc_s(n):
    """Out = x / (k + alpha * sum of squares over the window)^beta, the
    window ``[c - (n-1)//2, c + n - 1 - (n-1)//2]`` clipped to the
    channels; unlike torch.nn.LocalResponseNorm for every n (alpha / n
    there, and its even windows lean the other way)."""
    from paddle_tpu_torch.ops.nn_ops import _lower_lrn

    k, alpha, beta = 2.0, 1e-3, 0.75
    x = _X.astype(np.float64)
    want = np.empty_like(x)
    lo = (n - 1) // 2
    for c in range(x.shape[1]):
        win = range(max(0, c - lo), min(x.shape[1], c + n - lo))
        s = sum(x[:, j] ** 2 for j in win)
        want[:, c] = x[:, c] / (k + alpha * s) ** beta
    got = _lower_lrn(None, {"X": [torch.from_numpy(_X)]},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    np.testing.assert_allclose(got["Out"].numpy(), want, rtol=1e-5)
    lrn = torch.nn.LocalResponseNorm(n, alpha=alpha, beta=beta, k=k)
    assert not np.allclose(lrn(torch.from_numpy(_X)).numpy(), want,
                           rtol=1e-3)
