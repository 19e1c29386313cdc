"""K-epi: the layer epilogue of an evaluation forward in one pass.

Counterpart of the XLA fusion the reference's evaluation forward makes of
a BatchNorm with what comes before and after it
(``pygim_tpu/nn/layers.py:batchnorm_apply``, the conv or linear bias,
``pygim_tpu/ops/spmm.py:raw_mul_quantized``'s dequantize ``out * scale``
and the ReLU of ``pygim_tpu/nn/models.py:gnn_apply``)::

    y = relu(((a · s + c) − mean) · inv · γ + β),  inv = rsqrt(var + eps)

over ``a`` (N, H) float32, with ``s`` an optional 0-dim float32 scale on
a's device (read by the kernel on the card: no host synchronisation) and
``c`` an optional (H,) bias. The CUDA kernel is ``csrc/epilogue.cu``: one
read of ``a`` and one write of ``y``, every step rounded alone in the
order of :func:`epilogue_plain`, so the two agree bit for bit (NaN kept
by the ReLU, as ``torch.relu`` keeps it). :func:`epilogue` computes
``inv`` once per column for both.
"""

from __future__ import annotations

import torch

from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (plain int; launches only)
launches = 0


def epilogue_plain(a, mean, inv, gamma, beta, scale=None, bias=None):
    """The same chain as PyTorch ops: ``a * scale``, ``+ bias``, the
    BatchNorm of ``nn/layers.py:batchnorm_apply`` with ``inv`` for
    ``rsqrt(var + eps)``, ``torch.relu``."""
    y = a if scale is None else a * scale
    if bias is not None:
        y = y + bias
    return torch.relu((y - mean) * inv * gamma + beta)


def _vec_ok(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def epilogue(a, mean, var, gamma, beta, eps: float, scale=None, bias=None):
    """``relu(((a · scale + bias) − mean) · rsqrt(var + eps) · gamma +
    beta)`` as a new tensor; ``scale`` (0-dim) and ``bias`` (H,) may be
    None. CPU tensors take :func:`epilogue_plain`; CUDA tensors launch the
    kernel (``a`` float32 (N, H) contiguous, the rest float32 on its
    device) or raise."""
    global launches
    _build.refuse_grad("epilogue", *(t for t in (a, mean, var, gamma, beta,
                                                 scale, bias) if t is not None))
    inv = torch.rsqrt(var + eps)
    if a.device.type == "cpu":
        return epilogue_plain(a, mean, inv, gamma, beta, scale, bias)
    if a.device.type != "cuda":
        raise ValueError(f"no K-epi kernel for device {a.device}")
    if a.dim() != 2 or a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(f"K-epi takes a contiguous float32 (N, H) input, got "
                         f"{a.dtype} {tuple(a.shape)}")
    n, h = a.shape
    cols = [t for t in (mean, inv, gamma, beta, bias) if t is not None]
    for t in cols + ([] if scale is None else [scale]):
        if t.device != a.device or t.dtype != torch.float32:
            raise ValueError("K-epi's parameters are float32 on a's device")
    if any(t.shape != (h,) or not t.is_contiguous() for t in cols):
        raise ValueError(f"K-epi's per-column parameters are ({h},), "
                         "contiguous")
    if scale is not None and scale.dim() != 0:
        raise ValueError("K-epi's scale is a 0-dim tensor")
    y = torch.empty_like(a)
    vec = int(h % 4 == 0 and _vec_ok(a, y, *cols))
    lib = _build.load("epilogue")
    with torch.cuda.device(a.device):
        err = lib.epilogue(
            a.data_ptr(), y.data_ptr(), n, h, vec,
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            _build.stream_of(a))
    _build.check(err, "epilogue")
    launches += 1
    return y
