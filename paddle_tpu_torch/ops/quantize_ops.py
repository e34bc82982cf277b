"""Quantization-aware-training ops: fake quantize / dequantize.

Counterpart of ``paddle_tpu/ops/quantize_ops.py`` (the reference's
fake_quantize_op.cc and fake_dequantize_op.cc). The quantized value is
written ``y + (round(q) - y).detach()``, the JAX package's expression in
the same order, so the synthesized ``<op>_grad`` is the straight-through
estimator ``range / scale`` everywhere, clipped elements included. Every
scale stays a device tensor: no op reads a value back to the host.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op


def _quant_range(bit_length):
    return float((1 << (bit_length - 1)) - 1)


def _quantize(x, scale, bit_length, clip=True):
    """round(clip(x / scale) * range) forward, range / scale backward
    (``_quantize`` of the JAX package, expression for expression)."""
    rng = _quant_range(bit_length)
    scale = torch.clamp_min(scale, 1e-8)
    y = x / scale * rng
    q = y
    if clip:
        q = torch.clamp(x / scale, -1.0, 1.0) * rng
    return y + (torch.round(q) - y).detach()


def _lower_fake_quantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    scale = torch.amax(torch.abs(x)).detach()
    # no clip: |x| <= scale by construction
    return {"Out": _quantize(x, scale, attrs.get("bit_length", 8),
                             clip=False),
            "OutScale": scale.reshape(1)}


register_op(
    "fake_quantize_abs_max",
    inputs=["X"],
    outputs=["Out", "OutScale"],
    attrs={"bit_length": 8},
    lower=_lower_fake_quantize_abs_max,
    intermediate_outputs=("OutScale",),
)


def _lower_fake_quantize_range_abs_max(ctx, ins, attrs):
    """Training: the envelope max(InScale, max|x|) (the JAX package's
    stand-in for the reference's windowed decay); test time (``ctx.is_test``
    or the ``is_test`` attr): InScale unchanged. OutScale writes the
    same persistable state back."""
    x = ins["X"][0]
    in_scale = ins["InScale"][0].reshape(())
    if ctx.is_test or attrs.get("is_test", False):
        scale = in_scale
    else:
        scale = torch.maximum(in_scale, torch.amax(torch.abs(x)))
    scale = scale.detach()
    return {"Out": _quantize(x, scale, attrs.get("bit_length", 8)),
            "OutScale": scale.reshape(1)}


register_op(
    "fake_quantize_range_abs_max",
    inputs=["X", "InScale"],
    outputs=["Out", "OutScale"],
    attrs={"bit_length": 8, "window_size": 10000, "is_test": False},
    lower=_lower_fake_quantize_range_abs_max,
    no_grad_inputs=("InScale",),
    intermediate_outputs=("OutScale",),
)


def _lower_fake_dequantize_max_abs(ctx, ins, attrs):
    """Out = X * Scale / max_range. XLA turns the division by the
    constant into a product with its float32 reciprocal; so does this
    lowering, so the values are the JAX package's bit for bit."""
    scale = ins["Scale"][0].reshape(())
    x = ins["X"][0].to(scale.dtype)
    return x * scale * (1.0 / attrs.get("max_range", 127.0))


register_op(
    "fake_dequantize_max_abs",
    inputs=["X", "Scale"],
    outputs=["Out"],
    attrs={"max_range": 127.0},
    lower=_lower_fake_dequantize_max_abs,
    no_grad_inputs=("Scale",),
)


def _lower_dequantize_weight(ctx, ins, attrs):
    """int8 storage to float: Out = X_int8 * step, the step (scale /
    max_range) that ``convert_to_int8`` stored."""
    step = ins["Scale"][0].reshape(())
    return ins["X"][0].to(step.dtype) * step


register_op(
    "dequantize_weight",
    inputs=["X", "Scale"],
    outputs=["Out"],
    attrs={},
    lower=_lower_dequantize_weight,
    no_grad_inputs=("X", "Scale"),
)
