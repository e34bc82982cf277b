"""Full attention masks through the PyTorch port against the JAX package.

A full ``[B, 1|H, T, S]`` mask takes the JAX package's XLA reference path
(``flash_attention_reference`` with the GQA repeat and the window band,
``paddle_tpu/kernels/flash_attention.py:661-676``); the port routes it by
the mask's rank to ``attention_reference``. Both are held together here:

- ``flash_attention`` with ``[B, 1, T, S]`` and ``[B, H, T, S]`` masks,
  composed with GQA, a sliding window, causal and T != S, including rows
  that see no key (the uniform mean of V, as in the reference): forward
  and gradient (``jax.vjp`` against ``torch.autograd``) within 2e-5, one
  counted call of ``attention_reference`` per forward;
- the ``scaled_dot_product_attention`` op with a full ``Mask`` input, as
  a program through both packages' executors: the output and the
  gradients of q, k and v (``calc_gradient``) within 2e-5.

Tolerance: 2e-5 absolute (fp32 softmax sums in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.testing import fresh_state

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

B, H, D = 2, 4, 16
TOL = 2e-5

# name -> (T, S, mask heads: 1 or H, options)
CASES = {
    "b1_mask": (9, 9, 1, {}),
    "bh_mask": (9, 9, H, {}),
    "bh_mask_T7_S11": (7, 11, H, {}),
    "b1_mask_causal": (10, 10, 1, {"causal": True}),
    "bh_mask_gqa_window": (12, 12, H, {"kv_group": 2, "window": 4}),
    "b1_mask_gqa_causal_window": (12, 12, 1, {"kv_group": 4, "causal": True,
                                              "window": 3}),
    "bh_mask_dead_rows": (8, 10, H, {"kv_group": 2}),
}


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _inputs(name, seed=0):
    T, S, mh, opts = CASES[name]
    rng = np.random.RandomState(seed)
    g = opts.get("kv_group", 1)
    q = rng.randn(B, H, T, D).astype("float32")
    k = rng.randn(B, H // g, S, D).astype("float32")
    v = rng.randn(B, H // g, S, D).astype("float32")
    dout = rng.randn(B, H, T, D).astype("float32")
    mask = (rng.rand(B, mh, T, S) > 0.3).astype("float32")
    if name == "bh_mask_dead_rows":
        mask[0, 1, 3] = 0.0  # one row that sees no key
        mask[1, :, 5] = 0.0  # and the same row in every head
    return q, k, v, dout, mask, opts


@pytest.mark.parametrize("name", sorted(CASES))
def test_full_mask_matches_jax(name):
    q, k, v, dout, mask, opts = _inputs(name)
    scale = D ** -0.5

    def fwd(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, sm_scale=scale,
                                   mask=jnp.asarray(mask), **opts)

    want, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = [np.asarray(x) for x in vjp(jnp.asarray(dout))]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    calls = tfa.ATTENTION_REFERENCE.calls
    out = tfa.flash_attention(*leaves, sm_scale=scale,
                              mask=torch.from_numpy(mask), **opts)
    assert tfa.ATTENTION_REFERENCE.calls == calls + 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w, what in zip(got, want_grads, ("dq", "dk", "dv")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL,
                                   err_msg=what)
    if name == "bh_mask_dead_rows":
        # a row that sees no key is the mean of its kv head's V rows
        g = opts["kv_group"]
        for b, h, t in ((0, 1, 3), (1, 0, 5), (1, 3, 5)):
            np.testing.assert_allclose(out[b, h, t].detach().numpy(),
                                       v[b, h // g].mean(axis=0), rtol=0,
                                       atol=TOL)


def _sdpa_program(pkg, unique_name, T, S, opts, kv_heads):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        q = pkg.layers.data("q", shape=[H, T, D], stop_gradient=False)
        k = pkg.layers.data("k", shape=[kv_heads, S, D], stop_gradient=False)
        v = pkg.layers.data("v", shape=[kv_heads, S, D], stop_gradient=False)
        mask = pkg.layers.data("mask", shape=[H, T, S])
        dout = pkg.layers.data("dout", shape=[H, T, D])
        out = pkg.layers.scaled_dot_product_attention(
            q, k, v, mask=mask, causal=opts.get("causal", False),
            kv_group=opts.get("kv_group", 1), window=opts.get("window", 0))
        grads = pkg.backward.calc_gradient(out, [q, k, v],
                                           target_gradients=[dout])
    return main, [out] + list(grads)


@pytest.mark.parametrize("name", ["bh_mask", "bh_mask_gqa_window",
                                  "bh_mask_dead_rows"])
def test_sdpa_op_full_mask_matches_jax(name):
    q, k, v, dout, mask, opts = _inputs(name, seed=1)
    T, S = q.shape[2], k.shape[2]
    feed = {"q": q, "k": k, "v": v, "mask": mask, "dout": dout}
    res = {}
    for key, pkg, unique_name in (("jax", jfluid, j_unique_name),
                                  ("torch", tfluid, t_unique_name)):
        main, fetch = _sdpa_program(pkg, unique_name, T, S, opts,
                                    k.shape[1])
        exe = pkg.Executor(pkg.CPUPlace())
        res[key] = [np.asarray(x) for x in exe.run(main, feed=feed,
                                                   fetch_list=fetch)]
    for got, want, what in zip(res["torch"], res["jax"],
                               ("out", "dq", "dk", "dv")):
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)
