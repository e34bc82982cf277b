"""jax.random's threefry2x32 stream in PyTorch, integer-exact.

The port's counterpart of what ``jax.random`` gives the JAX package:
``PRNGKey``, ``fold_in``, ``split``, ``random_bits`` and the samplers
``uniform``, ``normal``, ``truncated_normal``, ``bernoulli``,
``randint``, ``gumbel`` and ``categorical``, drawing the same numbers
from the same keys. The reference is jax 0.9 with
``jax_threefry_partitionable=True`` and the ``threefry2x32``
implementation (``jax/_src/prng.py`` ``threefry_2x32``,
``threefry_seed``, ``threefry_fold_in``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``, ``iota_2x32_shape``;
``jax/_src/random.py`` for the samplers):

* a key is two uint32 words; ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)``, and
  ``split(key, n)[i]`` hashes ``(0, i)``: so ``split(key, n)[i] ==
  fold_in(key, i)``;
* the bits of a draw of ``shape`` hash, for each flat row-major index
  ``i``, the pair ``(i >> 32, i & 0xFFFFFFFF)``; 32-bit bits are the xor
  of the two output words;
* a float32 uniform takes the top 23 bits as the mantissa of a float in
  [1, 2), subtracts 1 and scales: XLA on the CPU contracts
  ``u * (max - min) + min`` into one fused multiply-add, and so does
  this module (exactly: the product in float64, the sum rounded once).

Words are uint32 values in int64 tensors (torch has no full uint32
arithmetic): every add is masked back to 32 bits, and a rotation is two
shifts and an or. The bulk of a draw hashes int32 words in place
instead (two's-complement adds wrap as uint32 adds do; a right shift is
masked), a chunk of counters at a time. Keys are int64 tensors ``[2]``
or ``[K, 2]`` on the caller's device.

Key chains. The executor derives an op's key as ``fold_in(fold_in(
run_key, step), op_id)``, and a sampler's as ``fold_in(fold_in(
PRNGKey(seed), slot), position)``. A :class:`KeyChain` holds such a key
unevaluated: a base key, the integers folded into it, then up to two
per-row data tensors. Drawing from a chain folds on the fly, so on the
card one launch of the threefry kernel (``kernels/threefry.py``) derives
the key and draws. Every draw goes through :func:`_draw`: on a CUDA
tensor it launches that kernel (or raises), elsewhere it runs
:func:`plain_draw`, this module's torch-op version of the same hash.

The normal family goes through ``erf_inv``, written here as XLA writes
it for float32 (Giles' polynomial, ``chlo.erf_inv``), so it agrees with
the JAX package to within the ulps of ``log1p`` and ``sqrt``.
"""

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# the draw modes of plain_draw and the kernel (csrc/threefry.cu)
MODE_KEY, MODE_BITS, MODE_UNIFORM, MODE_BERNOULLI = range(4)
MAX_FOLDS = 4      # integers a chain folds in before its rows
MAX_ROW_FOLDS = 2  # per-row data tensors a chain folds in last


# -- the hash ---------------------------------------------------------------

def hash_words(k0, k1, x0, x1):
    """threefry2x32 of the counter pair ``(x0, x1)`` under the key
    ``(k0, k1)``: 20 rounds, a key injection every 4, on Python ints
    (a key known on the host); returns the two output words. Tensors
    hash through :func:`_hash_int32`."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def _fold_host(pair, data):
    return hash_words(pair[0], pair[1], 0, int(data) & MASK)


def PRNGKey_pair(seed):
    """``PRNGKey(seed)``'s two words as Python ints."""
    return (0, int(seed) & MASK)


# -- keys -------------------------------------------------------------------

def PRNGKey(seed, device=None):
    """``jax.random.PRNGKey(seed)``: an int64 tensor ``[2]``,
    ``(0, seed mod 2**32)``."""
    return torch.tensor(PRNGKey_pair(seed), dtype=torch.int64, device=device)


class KeyChain(object):
    """A key held unevaluated: ``base`` with ``folds`` folded in, in
    order, then each of ``row_data`` (``[K]`` tensors, one value a row).

    ``base`` is an int64 tensor ``[2]`` or ``[K, 2]``, or a pair of
    Python ints (a key known on the host). Integer folds on a host pair
    are done on the host at once."""

    __slots__ = ("base", "folds", "row_data")

    def __init__(self, base, folds=(), row_data=()):
        if not isinstance(base, torch.Tensor):
            base = (int(base[0]) & MASK, int(base[1]) & MASK)
            for d in folds:
                base = _fold_host(base, d)
            folds = ()
        self.base = base
        self.folds = tuple(int(d) & MASK for d in folds)
        self.row_data = tuple(row_data)
        if len(self.row_data) > MAX_ROW_FOLDS:
            raise ValueError("a key chain folds at most %d row tensors"
                             % MAX_ROW_FOLDS)

    def fold_in(self, data):
        """The chain with ``data`` folded in: an int, or a ``[K]``
        integer tensor (one value a row). Nothing is computed."""
        if isinstance(data, torch.Tensor) and data.dim() > 0:
            return KeyChain(self.base, self.folds,
                            self.row_data + (data.reshape(-1),))
        if self.row_data:
            raise ValueError("an integer fold after a row fold: "
                             "materialize the chain first")
        data = int(data)
        if not isinstance(self.base, torch.Tensor):
            return KeyChain(_fold_host(self.base, data))
        if len(self.folds) == MAX_FOLDS:
            return KeyChain(key_data(self)).fold_in(data)
        return KeyChain(self.base, self.folds + (data,))

    def rows(self):
        """Rows of keys the chain stands for (1 for a single key)."""
        n = 1
        if isinstance(self.base, torch.Tensor) and self.base.dim() == 2:
            n = self.base.shape[0]
        for t in self.row_data:
            m = t.numel()
            if n == 1:
                n = m
            elif m not in (1, n):
                raise ValueError("key chain rows disagree: %d and %d"
                                 % (n, m))
        return n

    def batched(self):
        return ((isinstance(self.base, torch.Tensor)
                 and self.base.dim() == 2) or bool(self.row_data))

    def device(self, requested=None):
        """The device a draw from the chain runs on: its tensors' (base
        key, row data), else ``requested``, else the CPU. A
        ``requested`` device that the tensors are not on raises: a draw
        is never moved to another device without a word."""
        own = [self.base] if isinstance(self.base, torch.Tensor) else []
        own += list(self.row_data)
        for t in own:
            if requested is not None and not _same_device(t.device,
                                                          requested):
                raise ValueError("a key chain on %s drawn on %s: move the "
                                 "key first" % (t.device, requested))
        if own:
            return own[0].device
        return torch.device(requested) if requested is not None else \
            torch.device("cpu")


def _same_device(have, requested):
    """Whether a tensor on ``have`` lies on ``requested`` (``"cuda"``
    without an index matches any card)."""
    requested = torch.device(requested)
    return have.type == requested.type and (
        requested.index is None or have.index == requested.index)


def as_chain(key):
    return key if isinstance(key, KeyChain) else KeyChain(key)


def key_data(key, device=None):
    """The key a chain stands for, as an int64 tensor ``[2]`` (or
    ``[K, 2]``); a tensor key comes back as it is."""
    if isinstance(key, torch.Tensor):
        return key
    chain = as_chain(key)
    if (not isinstance(chain.base, torch.Tensor) and not chain.row_data):
        return torch.tensor(chain.base, dtype=torch.int64,
                            device=device)
    out = _draw(chain, 1, MODE_KEY, device=device)
    return out if chain.batched() else out.reshape(2)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: a new key tensor. ``data`` is
    an int, or a ``[K]`` tensor folded into row ``k`` of the keys."""
    return key_data(as_chain(key).fold_in(data))


def split(key, num=2, device=None):
    """``jax.random.split(key, num)``: ``[num, 2]`` (``[K, num, 2]``
    for ``[K, 2]`` keys). Key ``i`` is ``fold_in(key, i)``: one row fold
    of ``arange(num)``."""
    chain = as_chain(key)
    num = int(num)
    if chain.batched():
        keys = key_data(chain, device)
        k = keys.shape[0]
        rows = KeyChain(keys.repeat_interleave(num, dim=0), (), (
            torch.arange(num, device=keys.device).repeat(k),))
        return key_data(rows).reshape(k, num, 2)
    dev = chain.device(device)
    return key_data(chain.fold_in(torch.arange(num, device=dev)))


# -- draws ------------------------------------------------------------------

def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _shaped(chain, flat, shape):
    shape = tuple(int(d) for d in shape)
    if chain.batched():
        return flat.reshape((flat.shape[0],) + shape)
    return flat.reshape(shape)


def random_bits(key, shape, device=None):
    """``jax.random.bits(key, shape)`` (32-bit): uint32 values in an
    int64 tensor; ``[K, *shape]`` for ``[K, 2]`` keys."""
    chain = as_chain(key)
    return _shaped(chain, _draw(chain, _numel(shape), MODE_BITS,
                                device=device), shape)


def _f32(x):
    return float(np.float32(x))


def uniform(key, shape, minval=0.0, maxval=1.0, device=None):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    chain = as_chain(key)
    return _shaped(chain, _draw(chain, _numel(shape), MODE_UNIFORM,
                                lo=minval, hi=maxval, device=device), shape)


def bernoulli(key, p, shape, dtype=torch.bool, device=None):
    """``jax.random.bernoulli(key, p, shape)`` (``uniform < float32(p)``)
    as ``dtype`` (bool, or float32 0/1)."""
    chain = as_chain(key)
    return _shaped(chain, _draw(chain, _numel(shape), MODE_BERNOULLI, p=p,
                                dtype=dtype, device=device), shape)


def randint(key, shape, minval, maxval, device=None):
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 (the
    JAX package's int dtype): two draws of bits from ``split(key)``,
    reduced modulo the span as jax reduces them. Returns int64."""
    chain = as_chain(key)
    lo, hi = int(minval), int(maxval)
    span = (hi - lo) & MASK if hi > lo else 1
    higher = random_bits(chain.fold_in(0), shape, device=device)
    lower = random_bits(chain.fold_in(1), shape, device=device)
    # uint32 arithmetic, as jax's: the square wraps
    mult = (((2 ** 16 % span) ** 2) & MASK) % span
    off = _mul_mod32(higher % span, mult)
    off = ((off + lower % span) & MASK) % span
    out = (off + lo) & MASK
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)


def _mul_mod32(a, b):
    """``a * b mod 2**32`` for uint32 values in int64 (``b`` an int),
    without overflowing int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as XLA's contracted
    multiply-add on the CPU and ``fmaf`` on the card round it: the
    product is exact in float64 (``a`` a tensor; ``b`` and ``c`` tensors
    or numbers); the float64 sum is nudged where its
    rounding would put it on a float32 tie that the exact sum misses."""
    b = b.double() if isinstance(b, torch.Tensor) else _f32(b)
    p = a.double() * b
    # scalars stay Python numbers: no host-to-device copy (which a CUDA
    # graph capture refuses)
    c = c.double() if isinstance(c, torch.Tensor) else \
        torch.full_like(p, _f32(c))
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    bits = s.view(torch.int64)
    tie = ((bits & 0x1FFFFFFF) == 0x10000000) & (err != 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(tie, bits + step, bits)
    return bits.view(torch.float64).float()


# XLA's float32 erf_inv (Giles; chlo.erf_inv's decomposition)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x):
    """float32 ``erf_inv`` as XLA computes it (its polynomial, with the
    multiply-adds contracted)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i]), _f32(_ERFINV_GE5[i]))

    p = coef(0)
    for i in range(1, 9):
        p = fma32(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


_SQRT2 = _f32(math.sqrt(2.0))


def normal(key, shape, device=None):
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform in ``(-1, 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device)
    return _SQRT2 * erf_inv(u)


def truncated_normal(key, lower, upper, shape, device=None):
    """``jax.random.truncated_normal(key, lower, upper, shape)``
    (float32)."""
    lower32, upper32 = np.float32(lower), np.float32(upper)
    a = math.erf(float(lower32 / np.float32(_SQRT2)))
    b = math.erf(float(upper32 / np.float32(_SQRT2)))
    u = uniform(key, shape, _f32(a), _f32(b), device=device)
    out = _SQRT2 * erf_inv(u)
    return torch.clamp(
        out, float(np.nextafter(lower32, np.float32(np.inf))),
        float(np.nextafter(upper32, np.float32(-np.inf))))


TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape, device=None):
    """``jax.random.gumbel(key, shape)`` (mode "low"):
    ``-log(-log(uniform(tiny, 1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0,
                                         device=device)))


def categorical(key, logits, axis=-1):
    """``jax.random.categorical(key, logits, axis)``: the argmax of
    Gumbel noise plus the logits. With ``[K, 2]`` keys (or a batched
    chain), row ``k`` of ``logits`` (``[K, V]``) samples with key ``k``,
    as ``vmap(categorical)`` does."""
    chain = as_chain(key)
    logits = logits.to(torch.float32)
    if chain.batched():
        if axis not in (-1, 1) or logits.dim() != 2:
            raise ValueError("batched categorical takes [K, V] logits on "
                             "the last axis")
        g = gumbel(chain, (logits.shape[1],), device=logits.device)
        return torch.argmax(g + logits, dim=-1)
    g = gumbel(chain, tuple(logits.shape), device=logits.device)
    return torch.argmax(g + logits, dim=axis)


# -- the draw: kernel on the card, torch ops elsewhere ---------------------

def _draw(chain, n, mode, lo=0.0, hi=1.0, p=0.0, dtype=None, device=None):
    """Every draw of this module: ``[rows, n]`` (``[rows, 2]`` for
    keys), on the chain's device (its base or row tensors), else
    ``device``. The threefry kernel's wrapper
    launches the kernel on a CUDA device and runs :func:`plain_draw`
    elsewhere."""
    from paddle_tpu_torch.kernels import threefry as _kthreefry

    return _kthreefry.threefry_draw(chain, n, mode, lo=lo, hi=hi, p=p,
                                    dtype=dtype, device=device)


def chain_keys(chain, device):
    """The keys a chain stands for, ``[rows, 2]`` int64 on ``device``,
    each fold one :func:`_hash_int32` of the counter pair ``(0, d)``."""
    base = chain.base
    if isinstance(base, torch.Tensor):
        k = base.to(device=device, dtype=torch.int64).reshape(-1, 2)
    else:
        k = torch.tensor([base], dtype=torch.int64, device=device)
    k = _as_int32(k & MASK)
    k0, k1 = k[:, :1], k[:, 1:]
    data = [torch.full((1, 1), d, dtype=torch.int64, device=device)
            for d in chain.folds]
    data += [t.to(device=device, dtype=torch.int64).reshape(-1, 1)
             for t in chain.row_data]
    for d in data:
        x1 = _as_int32(d & MASK).expand(
            max(d.shape[0], k0.shape[0]), 1).contiguous()
        x0 = torch.zeros_like(x1)
        _hash_int32(k0, k1, x0, x1, torch.empty_like(x1))
        k0, k1 = x0, x1
    return torch.cat([k0, k1], dim=1).to(torch.int64) & MASK


# counters hashed at once by plain_draw: the words stay in cache, and
# each torch op still has enough work for the CPU's threads
_CHUNK = 1 << 20


def _as_int32(t):
    """uint32 values held in int64, as int32 tensors of the same bits."""
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)


def _hash_int32(k0, k1, x0, x1, tmp):
    """threefry2x32 (:func:`hash_words`) in place on int32 words
    (``[rows, c]``; keys ``[rows, 1]``): two's-complement adds wrap as
    uint32 adds do, and a rotation's right shift is masked to make it
    logical. ``tmp`` is scratch of ``x1``'s shape."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0.add_(k0)
    x1.add_(k1)
    for g in range(5):
        for r in _ROT[g % 2]:
            x0.add_(x1)
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1.bitwise_right_shift_(32 - r).bitwise_and_((1 << r) - 1)
            x1.bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[(g + 1) % 3])
        x1.add_(ks[(g + 2) % 3]).add_(g + 1)


def draw_out(mode, rows, n, dtype, device):
    """The output tensor of a draw (``_draw``'s shapes; not the keys)."""
    if mode == MODE_BITS:
        return torch.empty((rows, n), dtype=torch.int64, device=device)
    if mode == MODE_UNIFORM:
        return torch.empty((rows, n), dtype=torch.float32, device=device)
    if mode == MODE_BERNOULLI:
        return torch.empty((rows, n), device=device,
                           dtype=torch.bool if dtype is None else dtype)
    raise ValueError("unknown threefry draw mode %r" % (mode,))


def plain_draw(chain, n, mode, lo=0.0, hi=1.0, p=0.0, dtype=None,
               device=None):
    """The threefry kernel's plain version, in torch ops on any device:
    derive each row's key, hash counters ``0 .. n - 1`` (in chunks of
    ``_CHUNK``, on int32 words) and shape the words as ``mode`` asks
    (see :func:`_draw`)."""
    device = chain.device(device)
    keys = chain_keys(chain, device)
    if mode == MODE_KEY:
        return keys
    n = int(n)
    if n >= 2 ** 31:
        raise ValueError("threefry draws at most 2**31 - 1 counters a "
                         "row, not %d" % n)
    rows = keys.shape[0]
    out = draw_out(mode, rows, n, dtype, device)
    k0, k1 = _as_int32(keys[:, :1]), _as_int32(keys[:, 1:])
    step = max(1, _CHUNK // rows)
    tmp = torch.empty((rows, min(step, n)), dtype=torch.int32, device=device)
    span = _f32(np.float32(hi) - np.float32(lo))
    for s in range(0, n, step):
        e = min(n, s + step)
        # the counters' hi words are 0 below 2**32
        x1 = torch.arange(s, e, dtype=torch.int32, device=device).expand(
            rows, e - s).contiguous()
        x0 = torch.zeros_like(x1)
        _hash_int32(k0, k1, x0, x1, tmp[:, :e - s])
        bits = x0.bitwise_xor_(x1)
        if mode == MODE_BITS:
            out[:, s:e] = bits.to(torch.int64) & MASK
            continue
        f = (bits.bitwise_right_shift_(9).bitwise_and_(0x7FFFFF)
             .bitwise_or_(0x3F800000).view(torch.float32) - 1.0)
        if mode == MODE_UNIFORM:
            out[:, s:e] = torch.clamp(fma32(f, span, lo), min=_f32(lo))
        else:
            out[:, s:e] = f < _f32(p)
    return out
