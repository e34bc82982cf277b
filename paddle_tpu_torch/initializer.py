"""Parameter initializers: emit init OPS into the startup program.

Counterpart of ``paddle_tpu/initializer.py`` (python/paddle/fluid/
initializer.py parity) for the initializers whose ops this slice
registers: Constant (``fill_constant``), Uniform and Xavier
(``uniform_random``) and Normal (``gaussian_random``).
"""

import math


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


# Aliases matching fluid's public names.
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
