"""Flash attention forward of the PyTorch port against the JAX package.

The port's plain version of the ``flash_fwd`` kernel (the function its
CUDA kernel computes, and what a CPU tensor runs) is held against the
JAX package's Pallas ``_flash_kernel`` run in interpret mode on the CPU
(``flash_attention(..., force_pallas=True)`` and ``_flash_forward`` for
the log-sum-exp), on the same numpy inputs. Shapes are off the block grid
(T = S = 37). Tolerance: 2e-5 absolute (fp32, softmax sums taken in
another order).
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags as torch_flags
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.ops import attention_ops as t_attention_ops
from paddle_tpu_torch.testing import fresh_state

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

B, H, T, D = 2, 4, 37, 16
TOL = 2e-5

CASES = {
    "plain": {},
    "causal": {"causal": True},
    "ragged_mask": {"mask": [37, 20]},
    "kv_group_2": {"kv_group": 2, "mask": [30, 37]},
    "window_causal": {"causal": True, "window": 5},
    "window_bidirectional": {"window": 5, "mask": [37, 33]},
    "dead_row": {"mask": [0, 11]},
}


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    g = case.get("kv_group", 1)
    q = rng.randn(B, H, T, D).astype("float32")
    k = rng.randn(B, H // g, T, D).astype("float32")
    v = rng.randn(B, H // g, T, D).astype("float32")
    mask = None
    if "mask" in case:
        mask = np.zeros((B, T), "float32")
        for b, n in enumerate(case["mask"]):
            mask[b, :n] = 1.0
    return q, k, v, mask


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_matches_jax_pallas_interpret(name):
    case = CASES[name]
    q, k, v, mask = _inputs(case)
    causal = case.get("causal", False)
    window = case.get("window", 0)
    g = case.get("kv_group", 1)
    scale = D ** -0.5
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=scale, mask=None if mask is None else jnp.asarray(mask),
        force_pallas=True, kv_group=g, window=window))
    _, want_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal, scale, 128,
        128, True, kv_group=g, window=window)
    want_lse = np.asarray(want_lse)[:, :, 0, :T]  # TPU layout [B,H,1,T]
    out, lse = tfa.flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), causal=causal,
        sm_scale=scale, kv_group=g, window=window)
    out, lse = out.numpy(), lse.numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    dead = want_lse <= tfa.MASKED_ROW_LSE
    np.testing.assert_array_equal(lse <= tfa.MASKED_ROW_LSE, dead)
    np.testing.assert_allclose(lse[~dead], want_lse[~dead], rtol=0,
                               atol=TOL)
    if name == "dead_row":
        assert dead[0].all() and not dead[1].any()
        assert np.abs(out[0]).max() == 0.0


def test_flash_entry_point_normalizes_masks():
    """``flash_attention`` takes the key mask as [B, S] or [B, 1, 1, S],
    bool or float, on the kernels' path, and routes a full [B, H, T, S]
    mask by its rank to ``attention_reference`` (one counted call), which
    agrees where every row sees a key; ``key_mask`` refuses a full
    mask."""
    q, k, v, mask = _inputs({"mask": [37, 9]}, seed=1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    m2 = torch.from_numpy(mask)
    calls = tfa.ATTENTION_REFERENCE.calls
    base = tfa.flash_attention(tq, tk, tv, mask=m2)
    for m in (m2 > 0, m2[:, None, None, :]):
        torch.testing.assert_close(tfa.flash_attention(tq, tk, tv, mask=m),
                                   base, rtol=0, atol=0)
    assert tfa.ATTENTION_REFERENCE.calls == calls
    full = m2[:, None, None, :].expand(B, H, T, T)
    torch.testing.assert_close(tfa.flash_attention(tq, tk, tv, mask=full),
                               base, rtol=0, atol=TOL)
    assert tfa.ATTENTION_REFERENCE.calls == calls + 1
    with pytest.raises(ValueError, match="key-validity mask"):
        tfa.key_mask(torch.ones(B, H, T, T))


def test_kernel_path_takes_only_cuda_float32():
    """A tensor that is not on the CPU goes to the kernel path or raises:
    there is no quiet fall back to the plain version."""
    q, k, v, _ = _inputs({})
    meta = [torch.from_numpy(a).to("meta") for a in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward(*meta)


def test_reference_flag_is_refused_for_cuda_tensors():
    """FLAGS_attention_impl=reference never routes a CUDA tensor to the
    plain version: the op raises, naming the flag. On CPU tensors the
    flag is accepted (they run the plain version either way)."""
    cuda_like = types.SimpleNamespace(device=torch.device("cuda"))
    cpu_like = types.SimpleNamespace(device=torch.device("cpu"))
    old = torch_flags.get("attention_impl")
    torch_flags.set_flag("attention_impl", "reference")
    try:
        with pytest.raises(ValueError, match="FLAGS_attention_impl"):
            t_attention_ops._kernel_impl({}, "attention_impl", cuda_like)
        assert t_attention_ops._kernel_impl(
            {}, "attention_impl", cpu_like) == "reference"
        with pytest.raises(ValueError, match="FLAGS_paged_attention"):
            t_attention_ops._kernel_impl({"impl": "reference"},
                                         "paged_attention", cuda_like)
    finally:
        torch_flags.set_flag("attention_impl", old)
