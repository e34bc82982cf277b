"""Parameter initializers: emit init OPS into the startup program.

Counterpart of ``paddle_tpu/initializer.py`` (python/paddle/fluid/
initializer.py parity), the whole module: Constant (``fill_constant``),
Uniform, Xavier and MSRA (``uniform_random`` or ``gaussian_random``),
Normal (``gaussian_random``), TruncatedNormal
(``truncated_gaussian_random``), NumpyArray and Bilinear
(``assign_value``). The random ones draw the JAX package's numbers
(``core/prng.py``).
"""

import contextlib
import math

import numpy as np


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "value": float(self.value),
            },
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self.low,
                "max": self.high,
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return int(shape[0]) if shape else 1, int(shape[0]) if shape else 1
    receptive = 1
    for d in shape[2:]:
        receptive *= int(d)
    fan_in = int(shape[1]) * receptive if len(shape) > 2 else int(shape[0])
    fan_out = int(shape[0]) * receptive if len(shape) > 2 else int(shape[1])
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        fan_out = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fan_in)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / fan_in)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(self.value.shape),
                "dtype": var.dtype,
                "values": self.value.flatten().tolist(),
            },
        )


class BilinearInitializer(Initializer):
    """Bilinear upsampling kernel init for conv_transpose weights (the
    JAX package's formula)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer expects 4-D weights")
        c_out, c_in, h, w = shape
        weight = np.zeros(shape, dtype="float32")
        f = math.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(h):
            for j in range(w):
                v = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
                weight[:, :, i, j] = v
        return NumpyArrayInitializer(weight)(var, block)


# Aliases matching fluid's public names.
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


_force_init_on_cpu = False


def force_init_on_cpu():
    """True inside an ``init_on_cpu()`` block (initializer.py:32
    parity)."""
    return _force_init_on_cpu


@contextlib.contextmanager
def init_on_cpu():
    """Context manager marking initializer ops force_cpu
    (initializer.py:49 parity). The tag is advisory: the port places
    every initializer op on the executor's Place."""
    global _force_init_on_cpu
    prev = _force_init_on_cpu
    _force_init_on_cpu = True
    try:
        yield
    finally:
        _force_init_on_cpu = prev
