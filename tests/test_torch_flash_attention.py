"""Flash attention forward of the PyTorch port against the JAX package.

The port's plain version of the ``flash_fwd`` kernel (the function its
CUDA kernel computes, and what a CPU tensor runs) is held against the
JAX package's Pallas ``_flash_kernel`` run in interpret mode on the CPU
(``flash_attention(..., force_pallas=True)`` and ``_flash_forward`` for
the log-sum-exp), on the same numpy inputs. Shapes are off the block grid
(T = S = 37). Tolerance: 2e-5 absolute (fp32, softmax sums taken in
another order).

The CUDA kernel's rows path for T <= 4 (csrc/flash_fwd.cu on the
split-KV core of csrc/decode_split.cuh: the key splits of
``flash_rows_plan``, 32-key chunks skipped where no row sees a key,
an online softmax in the exp2 domain in which a hidden key gives p = 0,
partials per split and row, the merge, LSE = M ln 2 + ln L) is written
out as torch ops and held against the same Pallas kernel, out and LSE,
at T 1 to 4 over 160 keys (two splits): a wholly masked chunk and
split, a dead row, causal, both windows and ``kv_group`` 2.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import flags as torch_flags
from paddle_tpu_torch.kernels import decode_split
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


def _rows_split_merge(q, k, v, mask, causal, window, g, plan, scale):
    """csrc/flash_fwd.cu's rows path as torch ops: per (batch, head,
    split) the split's keys in chunks of ``decode_split.CHUNK``; a chunk
    where no row sees a key is skipped (the block-wide ballot); an
    online softmax of the exp2-domain scores per row with p = 0 for a
    hidden key; then the merge with weights exp2(m_i - M), exactly 0
    where M <= -1e29, and LSE = M ln 2 + ln max(L, 1e-30)."""
    B, H, T, d = q.shape
    S = k.shape[2]
    splits, kps = plan["splits"], plan["keys_per_split"]
    vis = tfa._visible(T, S, mask, causal, window, q.device).expand(
        B, 1, T, S)
    out = torch.zeros(B, H, T, d)
    lse = torch.zeros(B, H, T)
    for b in range(B):
        for h in range(H):
            kk, vv, vb = k[b, h // g], v[b, h // g], vis[b, 0]
            parts = []
            for sp in range(splits):
                m = torch.full((T,), tfa.NEG_INF)
                l = torch.zeros(T)
                acc = torch.zeros(T, d)
                hi = min(S, (sp + 1) * kps)
                for c0 in range(sp * kps, hi, decode_split.CHUNK):
                    c1 = min(hi, c0 + decode_split.CHUNK)
                    vc = vb[:, c0:c1]
                    if not vc.any():
                        continue
                    sc = (q[b, h] * scale * 1.4426950408889634) @ kk[c0:c1].T
                    sc = torch.where(vc, sc, torch.tensor(tfa.NEG_INF))
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(vc, torch.exp2(sc - m_new[:, None]),
                                    torch.tensor(0.0))
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vv[c0:c1]
                    m = m_new
                parts.append((m, l, acc))
            big_m = torch.stack([pm for pm, _, _ in parts]).max(dim=0).values
            w = [torch.exp2(pm - big_m) for pm, _, _ in parts]
            l_all = sum(pl * wi for (_, pl, _), wi in zip(parts, w))
            a_all = sum(pa * wi[:, None] for (_, _, pa), wi in zip(parts, w))
            dead = (big_m <= tfa.MASKED_ROW_LSE)[:, None]
            out[b, h] = torch.where(
                dead, torch.tensor(0.0),
                a_all / l_all.clamp(min=1e-30)[:, None])
            lse[b, h] = big_m * 0.6931471805599453 + torch.log(
                l_all.clamp(min=1e-30))
    return out, lse


ROWS_S = 160  # two splits of 96 and 64 keys under flash_rows_plan
ROWS_CASES = {
    # keys 32..63 of batch row 0 masked (a whole chunk); batch row 1 sees
    # keys 0..20 only, so its second split is wholly masked
    "chunk_and_split_masked": dict(T=4, mask=[[(0, 32), (64, 160)],
                                              [(0, 21)]]),
    "dead_row": dict(T=1, mask=[[], [(0, 160)]]),
    "causal_T4": dict(T=4, causal=True),
    "window_causal_T3": dict(T=3, causal=True, window=2),
    "window_two_sided_T2": dict(T=2, window=5, mask=[[(0, 160)],
                                                     [(1, 100)]]),
    "kv_group_2_T4": dict(T=4, kv_group=2, mask=[[(0, 150)], [(90, 160)]]),
}


def _rows_inputs(case, seed=3):
    rng = np.random.RandomState(seed)
    T, g = case["T"], case.get("kv_group", 1)
    q = rng.randn(B, H, T, D).astype("float32")
    k = rng.randn(B, H // g, ROWS_S, D).astype("float32")
    v = rng.randn(B, H // g, ROWS_S, D).astype("float32")
    mask = None
    if "mask" in case:
        # per batch row, the (lo, hi) spans of its valid keys
        mask = np.zeros((B, ROWS_S), "float32")
        for b, spans in enumerate(case["mask"]):
            for lo, hi in spans:
                mask[b, lo:hi] = 1.0
    return q, k, v, mask


@pytest.mark.parametrize("name", sorted(ROWS_CASES))
def test_rows_split_merge_matches_jax_pallas(name):
    case = ROWS_CASES[name]
    q, k, v, mask = _rows_inputs(case)
    T = case["T"]
    causal = case.get("causal", False)
    window = case.get("window", 0)
    g = case.get("kv_group", 1)
    scale = D ** -0.5
    plan = tfa.flash_rows_plan(B, H, T, ROWS_S, D, 132, 232448)
    assert plan["splits"] == 2
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=scale, mask=jm, force_pallas=True, kv_group=g,
        window=window))
    _, want_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal, scale,
        128, 128, True, kv_group=g, window=window)
    want_lse = np.asarray(want_lse)[:, :, 0, :T]
    out, lse = _rows_split_merge(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), causal, window,
        g, plan, scale)
    out, lse = out.numpy(), lse.numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=TOL)
    dead = want_lse <= tfa.MASKED_ROW_LSE
    np.testing.assert_array_equal(lse <= tfa.MASKED_ROW_LSE, dead)
    np.testing.assert_allclose(lse[~dead], want_lse[~dead], rtol=0,
                               atol=TOL)
    assert np.abs(out[dead]).max(initial=0.0) == 0.0
    if name == "dead_row":
        assert dead[0].all() and not dead[1].any()
