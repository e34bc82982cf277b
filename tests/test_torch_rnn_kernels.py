"""The recurrence kernels' modules of the PyTorch port against the JAX
package, on the CPU.

- ``paddle_tpu_torch.kernels.lstm_cell``: ``lstm_reference`` and
  ``fused_lstm`` against the JAX ``fused_lstm`` in Pallas interpret mode
  (``force_pallas=True``) and its XLA ``lstm_reference``, within 1e-5,
  for the four peephole x mask cases, the relu and identity activations
  and an initial state; gradients of xw, W_h, the bias and the peepholes
  against ``jax.vjp`` within 1e-5;
- ``paddle_tpu_torch.kernels.gru_cell``: the same for ``gru_reference`` /
  ``fused_gru`` (weights as column slices of one ``[D, 3D]`` weight, as
  the op passes them), gradients of xw, both weights and the bias;
- the kernels' ``autograd.Function``\\ s: their backward recomputes
  through the plain loop; with the launch replaced by the plain version
  (there is no card here) their gradients equal ``jax.vjp``'s;
- a tensor that is not on the CPU (``meta`` stands for the card here)
  reaches the kernel's checks and raises, in both wrappers; both kernels
  are in ``KERNELS`` and built from their sources.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import gru_cell as j_gru
from paddle_tpu.kernels import lstm_cell as j_lstm
from paddle_tpu_torch.kernels import KERNELS
from paddle_tpu_torch.kernels import build as t_build
from paddle_tpu_torch.kernels import gru_cell as t_gru
from paddle_tpu_torch.kernels import lstm_cell as t_lstm
from paddle_tpu_torch.testing import fresh_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _lstm_inputs(b=3, t=5, d=8, seed=0, peep=True, mask=True, init=False):
    """numpy inputs (the JAX test's scales); lengths include a 0."""
    rng = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (rng.randn(*s) * k).astype("float32")  # noqa: E731
    lens = np.array([t, 2, 0][:b])
    return dict(
        xw=f(b, t, 4 * d, k=0.4), w_h=f(d, 4 * d, k=0.3), bias=f(4 * d, k=0.1),
        peep=[f(d, k=0.1) for _ in range(3)] if peep else None,
        mask=((np.arange(t)[None, :] < lens[:, None]).astype("float32")
              if mask else None),
        h0=f(b, d, k=0.5) if init else None,
        c0=f(b, d, k=0.5) if init else None)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t_peep(p):
    return None if p is None else [_t(v) for v in p]


def _j_peep(p):
    return None if p is None else tuple(_j(v) for v in p)


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("peep,mask", [(True, True), (False, False),
                                       (True, False), (False, True)])
def test_lstm_matches_jax(peep, mask):
    a = _lstm_inputs(peep=peep, mask=mask)
    want = j_lstm.fused_lstm(_j(a["xw"]), _j(a["w_h"]), _j(a["bias"]),
                             peephole=_j_peep(a["peep"]), mask=_j(a["mask"]),
                             force_pallas=True)
    got = t_lstm.fused_lstm(_t(a["xw"]), _t(a["w_h"]), _t(a["bias"]),
                            peephole=_t_peep(a["peep"]), mask=_t(a["mask"]))
    _close(got, want)
    zero = torch.zeros(3, 8)
    _close(t_lstm.lstm_reference(_t(a["xw"]), _t(a["w_h"]), _t(a["bias"]),
                                 _t_peep(a["peep"]), zero, zero,
                                 _t(a["mask"])), want)


@pytest.mark.parametrize("acts", [("sigmoid", "relu", "identity"),
                                  ("identity", "tanh", "relu"),
                                  ("relu", "identity", "sigmoid")])
def test_lstm_activations_match_jax(acts):
    a = _lstm_inputs(seed=1)
    kw = dict(gate_act=acts[0], cell_act=acts[1], cand_act=acts[2])
    want = j_lstm.fused_lstm(_j(a["xw"]), _j(a["w_h"]), _j(a["bias"]),
                             peephole=_j_peep(a["peep"]), mask=_j(a["mask"]),
                             force_pallas=True, **kw)
    got = t_lstm.fused_lstm(_t(a["xw"]), _t(a["w_h"]), _t(a["bias"]),
                            peephole=_t_peep(a["peep"]), mask=_t(a["mask"]),
                            **kw)
    _close(got, want)


def test_lstm_initial_state_matches_jax():
    """The port's fused entry takes h0 / c0 (the JAX one starts from 0):
    held against the JAX ``lstm_reference`` with the same state; a row
    of length 0 keeps it at every step."""
    a = _lstm_inputs(seed=2, init=True)
    want = j_lstm.lstm_reference(_j(a["xw"]), _j(a["w_h"]), _j(a["bias"]),
                                 _j_peep(a["peep"]), _j(a["h0"]),
                                 _j(a["c0"]), _j(a["mask"]))
    got = t_lstm.fused_lstm(_t(a["xw"]), _t(a["w_h"]), _t(a["bias"]),
                            peephole=_t_peep(a["peep"]), mask=_t(a["mask"]),
                            h0=_t(a["h0"]), c0=_t(a["c0"]))
    _close(got, want)
    np.testing.assert_array_equal(got[0][2].numpy(),
                                  np.broadcast_to(a["h0"][2], (5, 8)))


def _lstm_cotangents(b=3, t=5, d=8):
    rng = np.random.RandomState(7)
    return [rng.randn(b, t, d).astype("float32") for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _lstm_vjp_case():
    """(inputs, cotangents, the JAX vjp of fused_lstm), computed once."""
    a = _lstm_inputs(seed=3)
    cots = _lstm_cotangents()

    def f(xw, w_h, bias, pi, pf, po):
        return j_lstm.fused_lstm(xw, w_h, bias, peephole=(pi, pf, po),
                                 mask=_j(a["mask"]), force_pallas=True)

    _, vjp = jax.vjp(f, _j(a["xw"]), _j(a["w_h"]), _j(a["bias"]),
                     *_j_peep(a["peep"]))
    return a, cots, vjp(tuple(_j(c) for c in cots))


def _torch_grads(fn, leaves, cots):
    leaves = [leaf.requires_grad_(True) for leaf in leaves]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, [_t(c) for c in cots])


def test_lstm_gradients_match_jax_vjp():
    a, cots, want = _lstm_vjp_case()
    got = _torch_grads(
        lambda xw, w_h, bias, pi, pf, po: t_lstm.fused_lstm(
            xw, w_h, bias, peephole=(pi, pf, po), mask=_t(a["mask"])),
        [_t(a["xw"]), _t(a["w_h"]), _t(a["bias"])] + _t_peep(a["peep"]),
        cots)
    _close(got, want)


def test_lstm_kernel_function_backward_matches_jax_vjp(monkeypatch):
    """``LSTMCellFunction``'s backward (the recompute through the plain
    loop), with its launch replaced by the plain version: there is no
    card here, and the backward never launches the kernel."""
    monkeypatch.setattr(t_lstm, "lstm_cell_forward", t_lstm.lstm_reference)
    a, cots, want = _lstm_vjp_case()
    got = _torch_grads(
        lambda xw, w_h, bias, pi, pf, po: t_lstm.LSTMCellFunction.apply(
            xw, w_h, bias, torch.stack([pi, pf, po]), None, None,
            _t(a["mask"]), ("sigmoid", "tanh", "tanh")),
        [_t(a["xw"]), _t(a["w_h"]), _t(a["bias"])] + _t_peep(a["peep"]),
        cots)
    _close(got, want)


def _gru_inputs(b=3, t=5, d=8, seed=0, mask=True, init=False):
    rng = np.random.RandomState(seed)
    f = lambda *s, k=1.0: (rng.randn(*s) * k).astype("float32")  # noqa: E731
    lens = np.array([t, 2, 0][:b])
    return dict(
        xw=f(b, t, 3 * d, k=0.4), w=f(d, 3 * d, k=0.3), bias=f(3 * d, k=0.1),
        mask=((np.arange(t)[None, :] < lens[:, None]).astype("float32")
              if mask else None),
        h0=f(b, d, k=0.5) if init else None)


def _gru_args(a, conv):
    w = conv(a["w"])
    d = a["w"].shape[0]
    return conv(a["xw"]), w[:, :2 * d], w[:, 2 * d:], conv(a["bias"])


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("acts", [("sigmoid", "tanh"), ("relu", "identity"),
                                  ("identity", "relu")])
def test_gru_matches_jax(mask, acts):
    a = _gru_inputs(mask=mask)
    want = j_gru.fused_gru(*_gru_args(a, _j), mask=_j(a["mask"]),
                           gate_act=acts[0], cand_act=acts[1],
                           force_pallas=True)
    got = t_gru.fused_gru(*_gru_args(a, _t), mask=_t(a["mask"]),
                          gate_act=acts[0], cand_act=acts[1])
    _close([got], [want])


def test_gru_initial_state_matches_jax():
    a = _gru_inputs(seed=2, init=True)
    want = j_gru.gru_reference(*_gru_args(a, _j), _j(a["h0"]), _j(a["mask"]))
    got = t_gru.fused_gru(*_gru_args(a, _t), mask=_t(a["mask"]),
                          h0=_t(a["h0"]))
    _close([got], [want])
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.broadcast_to(a["h0"][2], (5, 8)))


@functools.lru_cache(maxsize=None)
def _gru_vjp_case():
    """(inputs, cotangent, the JAX vjp of fused_gru), computed once."""
    a = _gru_inputs(seed=3)
    cot = np.random.RandomState(8).randn(3, 5, 8).astype("float32")

    def f(xw, wg, wc, bias):
        return j_gru.fused_gru(xw, wg, wc, bias, mask=_j(a["mask"]),
                               force_pallas=True)

    _, vjp = jax.vjp(f, *_gru_args(a, _j))
    return a, cot, vjp(_j(cot))


def _gru_leaves(a):
    xw, _, _, bias = _gru_args(a, _t)
    w = _t(a["w"]).requires_grad_(True)
    return xw, w, bias


def test_gru_gradients_match_jax_vjp():
    """Gradients of xw, W_gate, W_cand and the bias, the weights taken
    as column slices of one ``[D, 3D]`` parameter as ``dynamic_gru``
    takes them."""
    a, cot, want = _gru_vjp_case()
    d = 8
    got = _torch_grads(
        lambda xw, w, bias: t_gru.fused_gru(
            xw, w[:, :2 * d], w[:, 2 * d:], bias, mask=_t(a["mask"])),
        list(_gru_leaves(a)), [cot])
    _close([got[0], got[1][:, :2 * d], got[1][:, 2 * d:], got[2]], want)


def test_gru_kernel_function_backward_matches_jax_vjp(monkeypatch):
    monkeypatch.setattr(t_gru, "gru_cell_forward", t_gru.gru_reference)
    a, cot, want = _gru_vjp_case()
    d = 8
    got = _torch_grads(
        lambda xw, w, bias: t_gru.GRUCellFunction.apply(
            xw, w[:, :2 * d], w[:, 2 * d:], bias, None, _t(a["mask"]),
            ("sigmoid", "tanh")),
        list(_gru_leaves(a)), [cot])
    _close([got[0], got[1][:, :2 * d], got[1][:, 2 * d:], got[2]], want)


def test_validation_matches_jax():
    a = _lstm_inputs(peep=False, mask=False)
    with pytest.raises(ValueError, match="activation"):
        t_lstm.fused_lstm(_t(a["xw"]), _t(a["w_h"]), _t(a["bias"]),
                          gate_act="softsign")
    with pytest.raises(ValueError, match="4\\*D"):
        t_lstm.fused_lstm(_t(a["xw"])[:, :, :-4], _t(a["w_h"]),
                          _t(a["bias"]))
    g = _gru_inputs(mask=False)
    xw, wg, wc, bias = _gru_args(g, _t)
    with pytest.raises(ValueError, match="activation"):
        t_gru.fused_gru(xw, wg, wc, bias, cand_act="softsign")
    with pytest.raises(ValueError, match="3\\*D"):
        t_gru.fused_gru(xw[:, :, :-3], wg, wc, bias)


def test_cuda_tensors_never_reach_the_plain_versions():
    """On CUDA tensors the entries launch the kernel or raise; here,
    without a card, a tensor on the ``meta`` device stands for "not on
    the CPU": the kernels' checks raise."""
    a = _lstm_inputs()
    meta = lambda v: _t(v).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA device"):
        t_lstm.fused_lstm(meta(a["xw"]), meta(a["w_h"]), meta(a["bias"]),
                          peephole=[meta(p) for p in a["peep"]],
                          mask=meta(a["mask"]))
    g = _gru_inputs()
    xw, wg, wc, bias = _gru_args(g, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        t_gru.fused_gru(xw, wg, wc, bias, mask=meta(g["mask"]))


def test_both_kernels_are_registered_and_built_from_source():
    assert KERNELS["lstm_cell"] is t_lstm.LSTM_CELL
    assert KERNELS["gru_cell"] is t_gru.GRU_CELL
    for name, kern in (("lstm_cell.cu", t_lstm.LSTM_CELL),
                       ("gru_cell.cu", t_gru.GRU_CELL)):
        assert name in t_build.SOURCES
        with open(os.path.join(t_build.CSRC_DIR, name)) as f:
            src = f.read()
        assert 'extern "C" int %s(' % kern.symbol in src
        assert kern.launches == 0
