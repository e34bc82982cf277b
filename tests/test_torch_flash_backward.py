"""Flash attention backward of the PyTorch port against the JAX package.

The port's plain version of the ``flash_bwd_dkv`` / ``flash_bwd_dq``
kernels (the function the CUDA kernels compute, and what a CPU tensor
runs) is held against ``jax.vjp`` of the JAX package's
``flash_attention(..., force_pallas=True, block_q=8, block_k=8)``: in
interpret mode on the CPU that runs the real ``_flash_bwd_dkv_kernel``
and ``_flash_bwd_dq_kernel`` Pallas bodies over several tiles. Same
numpy inputs and output gradient. Tolerance: 2e-5 absolute (fp32 sums
over up to 37 keys and 8 query heads, taken in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags as torch_flags
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.testing import fresh_state

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

B, H, D = 2, 4, 16
TOL = 2e-5

# the forward test's cases (tests/test_torch_flash_attention.py), T = S = 37,
# plus T != S
CASES = {
    "plain": {},
    "causal": {"causal": True},
    "ragged_mask": {"mask": [37, 20]},
    "kv_group_2": {"kv_group": 2, "mask": [30, 37]},
    "window_causal": {"causal": True, "window": 5},
    "window_bidirectional": {"window": 5, "mask": [37, 33]},
    "dead_row": {"mask": [0, 11]},
    "T19_S37": {"T": 19, "S": 37, "mask": [37, 13]},
}


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    g = case.get("kv_group", 1)
    T, S = case.get("T", 37), case.get("S", 37)
    q = rng.randn(B, H, T, D).astype("float32")
    k = rng.randn(B, H // g, S, D).astype("float32")
    v = rng.randn(B, H // g, S, D).astype("float32")
    dout = rng.randn(B, H, T, D).astype("float32")
    mask = None
    if "mask" in case:
        mask = np.zeros((B, S), "float32")
        for b, n in enumerate(case["mask"]):
            mask[b, :n] = 1.0
    return q, k, v, dout, mask


def _opts(case):
    return dict(causal=case.get("causal", False),
                kv_group=case.get("kv_group", 1),
                window=case.get("window", 0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_pallas_interpret(name):
    case = CASES[name]
    q, k, v, dout, mask = _inputs(case)
    opts = _opts(case)
    scale = D ** -0.5
    jmask = None if mask is None else jnp.asarray(mask)

    def fwd(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_, sm_scale=scale, mask=jmask, force_pallas=True,
            block_q=8, block_k=8, **opts)

    _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(dout))]

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    tmask = None if mask is None else torch.from_numpy(mask)
    out, lse = tfa.flash_forward(tq, tk, tv, tmask, sm_scale=scale, **opts)
    got = tfa.flash_backward(tq, tk, tv, tmask, out, lse, tdo,
                             sm_scale=scale, **opts)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL,
                                   err_msg=what)
    if name == "dead_row":
        # batch 0 sees no key: its rows and keys get exactly zero grads
        for g in got:
            assert np.abs(g[0].numpy()).max() == 0.0


@pytest.mark.parametrize("name", ["ragged_mask", "kv_group_2",
                                  "window_causal", "T19_S37"])
def test_autograd_function_end_to_end(name):
    """``flash_attention`` runs ``FlashAttentionFunction``; its gradient
    through ``torch.autograd.grad`` equals autograd through the plain
    forward, and ``torch.func.vjp`` takes the Function too (the
    setup_context form)."""
    case = CASES[name]
    q, k, v, dout, mask = _inputs(case, seed=1)
    opts = _opts(case)
    tmask = None if mask is None else torch.from_numpy(mask)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, mask=tmask, **opts)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    plain, _ = tfa.flash_forward_plain(*leaves, tmask, **opts)
    want = torch.autograd.grad(plain, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL)

    def f(q_, k_, v_):
        return tfa.flash_attention(q_, k_, v_, mask=tmask, **opts)

    _, vjp = torch.func.vjp(f, *(torch.from_numpy(a) for a in (q, k, v)))
    for g, w in zip(vjp(torch.from_numpy(dout)), want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL)


def test_reference_flag_differentiates_the_plain_forward_on_cpu():
    """FLAGS_flash_backward=reference: autograd through the plain forward
    on CPU tensors, equal to the default path; an unknown value raises."""
    q, k, v, dout, mask = _inputs(CASES["window_bidirectional"], seed=2)
    tmask = torch.from_numpy(mask)

    def grads():
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tfa.flash_attention(*leaves, mask=tmask, window=5)
        return torch.autograd.grad(out, leaves, torch.from_numpy(dout))

    old = torch_flags.get("flash_backward")
    try:
        base = grads()
        torch_flags.set_flag("flash_backward", "reference")
        for g, w in zip(grads(), base):
            torch.testing.assert_close(g, w, rtol=0, atol=TOL)
        torch_flags.set_flag("flash_backward", "bogus")
        with pytest.raises(ValueError, match="FLAGS_flash_backward"):
            grads()
    finally:
        torch_flags.set_flag("flash_backward", old)


def test_reference_flag_is_refused_for_cuda_tensors():
    old = torch_flags.get("flash_backward")
    torch_flags.set_flag("flash_backward", "reference")
    try:
        with pytest.raises(ValueError, match="FLAGS_flash_backward"):
            tfa.backward_impl(torch.device("cuda"))
        assert tfa.backward_impl(torch.device("cpu")) == "reference"
    finally:
        torch_flags.set_flag("flash_backward", old)
    assert tfa.backward_impl(torch.device("cuda")) == "pallas"


def test_kernel_wrappers_take_only_cuda_tensors():
    """The backward kernels' wrappers launch or raise: no quiet fall back
    to the plain version for a tensor that is not on the CPU."""
    q, k, v, dout, _ = _inputs({})
    meta = [torch.from_numpy(a).to("meta") for a in (q, k, v, dout)]
    lse = torch.empty(B, H, 37, device="meta")
    for fn in (tfa.flash_bwd_dkv, tfa.flash_bwd_dq):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*meta[:3], None, meta[3], lse, lse, False, D ** -0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_backward(*meta[:3], None, meta[3], lse, meta[3])
