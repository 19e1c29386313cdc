"""Symmetric scale quantization for the aggregate path.

Bit-compatible with ``pygim_tpu/quant/__init__.py``:

    scale = 2 * max|v| / 2**k,  k = 5 (int8), 10 (int16), 20 (int32),
                                 20 (float passthrough — still scaled+rounded)
    v_q   = round(v / scale)  (half to even) cast to the target dtype
    dequantize(out, scale_edge, scale_x) = out * (scale_edge * scale_x)

``dtype='bfloat16'`` casts directly with scale 1.0; ``dtype=None``
disables quantization. A zero scale (all-zero input) is replaced by 1,
so the quantized values and the dequantized output are exact zeros.
"""

from __future__ import annotations

import torch

_SCALE_EXP = {"int8": 5, "int16": 10, "int32": 20}


def dtype_name(dtype) -> str:
    """``'int8'`` for ``'int8'`` or ``torch.int8``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def quant_scale(v, dtype="int32"):
    """``(scale, safe)`` of :func:`symmetric_quantize` as 0-dim tensors on
    ``v``'s device, without a host synchronisation: ``safe`` is ``scale``
    with a zero replaced by 1. Divide by ``safe`` (``v / safe``, a true
    division: a 0-dim CUDA divisor is not turned into a reciprocal
    multiply), never multiply by its reciprocal, so the rounding matches
    the reference bit for bit. On the card one K-quant reduction
    (``ops/quant_prologue.py:abs_max_scale``) computes both."""
    # imported here: ops/ imports this module
    from pygim_tpu_torch.ops.quant_prologue import abs_max_scale

    _abs_max, scale, safe = abs_max_scale(v, dtype)
    return scale, safe


def symmetric_quantize(v, dtype="int32"):
    """Returns ``(scale, v_q)``."""
    if dtype is None:
        return torch.ones((), dtype=v.dtype, device=v.device), v
    name = dtype_name(dtype)
    if name == "bfloat16":
        return (torch.ones((), dtype=torch.float32, device=v.device),
                v.to(torch.bfloat16))
    scale, safe = quant_scale(v, name)
    if name in _SCALE_EXP or name == "int64":
        # one K-quant pass on the card; imported here as above
        from pygim_tpu_torch.ops.quant_prologue import quant_table

        return scale, quant_table(v, safe, name)
    return scale, torch.round(v / safe)


def symmetric_dequantize(out, scale_edge, scale_x):
    """``out * (scale_edge * scale_x)``; integer ``out`` is promoted to the
    scale's float dtype."""
    return out * (scale_edge * scale_x)
