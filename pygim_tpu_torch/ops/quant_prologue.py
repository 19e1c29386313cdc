"""K-quant: the quantize prologue of the quantized aggregate.

Counterpart of the XLA prologue of ``pygim_tpu/ops/spmm.py:
raw_mul_quantized`` (``:1576-1578``, ``:1587``, ``:1618-1624``) and of
``pygim_tpu/quant/__init__.py:symmetric_quantize``. Three entry points,
one CUDA source (``csrc/quant.cu``), counted together in :data:`launches`
and apart in :data:`entry_launches`:

* :func:`abs_max_scale` — one reduction over x: ``max|x|``, ``scale = 2 ·
  max|x| / 2^k`` and ``safe`` (``scale`` with 0 replaced by 1), as 0-dim
  float32 tensors on x's device, bit-equal to ``quant.quant_scale``'s
  PyTorch ops (NaN, inf and all-zero inputs included);
* :func:`quant_table` — ``round(x / safe)`` (the correctly rounded
  quotient, half to even, as ``csrc/payload.cuh`` rounds for K-tail-quant)
  cast to int8, int16, int32 or int64 in one pass: the int8 and int16
  aggregates' table, and the payload of the unfused quantize round trip;
* :func:`core_payload` — K-int's K-major limb payload written straight
  from x: the rank gather ``x[rows]``, rounded where ``safe`` is given (an
  integer x is taken as it is), as ``limbs`` balanced int8 digits of
  shape ``(limbs, h_pad, k_pad)``, bit-equal to
  ``core_int.limb_split(round(x[rows] / safe).to(int32), ...)``, pads
  included.

Each has its plain PyTorch version here; CPU tensors take it, CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import contextlib

import torch

from pygim_tpu_torch.ops import _build
from pygim_tpu_torch.ops.core_int import limb_split
from pygim_tpu_torch.quant import _SCALE_EXP, dtype_name

# kernel launches since the last reset (plain ints; launches only): all
# three entry points, and each apart
launches = 0
entry_launches = {"abs_max": 0, "table": 0, "payload": 0}

# the kernels' type codes (csrc/quant.cu)
TABLE_TYPES = {torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 6}
PAYLOAD_TYPES = {torch.float32: 0, torch.int8: 1, torch.int16: 2,
                 torch.int32: 3}
_PARTIALS = 1024  # csrc/quant.cu:MAX_BLOCKS, one partial max a block


def scale_exponent(dtype) -> int:
    """k of ``scale = 2 · max|x| / 2^k``: 5 (int8), 10 (int16), 20 (int32
    and every other name, the float passthrough's)."""
    return _SCALE_EXP.get(dtype_name(dtype), 20)


def _count(entry: str) -> None:
    global launches
    launches += 1
    entry_launches[entry] += 1


def _on_card(what: str, x) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    one; raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no K-quant kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    return True


def abs_max_scale_plain(x, dtype="int32"):
    """``(abs_max, scale, safe)`` as PyTorch ops."""
    abs_max = torch.linalg.vector_norm(x, float("inf"))  # max|x|, one pass
    scale = abs_max * 2.0 / (2.0 ** scale_exponent(dtype))
    return abs_max, scale, torch.where(scale == 0, torch.ones_like(scale),
                                       scale)


def abs_max_scale(x, dtype="int32"):
    """``(abs_max, scale, safe)``, 0-dim float32 tensors on x's device
    (module docstring); x float32 on the card."""
    _build.refuse_grad("abs_max_scale", x)
    if not _on_card("abs_max_scale", x):
        return abs_max_scale_plain(x, dtype)
    if x.dtype != torch.float32:
        raise ValueError(f"K-quant's max|x| takes float32, got {x.dtype}")
    partial = torch.empty(_PARTIALS, dtype=torch.int32, device=x.device)
    out = torch.empty(3, dtype=torch.float32, device=x.device)
    lib = _build.load("quant")
    with torch.cuda.device(x.device):
        err = lib.quant_abs_max(
            x.data_ptr(), x.numel(), int(x.data_ptr() % 16 == 0),
            partial.data_ptr(), 2.0 ** -scale_exponent(dtype), out.data_ptr(),
            _build.stream_of(x))
    _build.check(err, "quant_abs_max")
    _count("abs_max")
    return out[0], out[1], out[2]


def _int_dtype(dtype) -> torch.dtype:
    t = dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, dtype_name(dtype), None)
    if t not in TABLE_TYPES:
        raise ValueError(f"K-quant's table is int8, int16, int32 or int64, "
                         f"got {dtype!r}")
    return t


def quant_table_plain(x, safe, dtype):
    """``round(x / safe)`` cast to ``dtype``, as PyTorch ops."""
    return torch.round(x / safe).to(_int_dtype(dtype))


def quant_table(x, safe, dtype):
    """``round(x / safe)`` (a true division, half to even) as a new
    ``dtype`` tensor of x's shape: int8, int16, int32 or int64; x float32
    and ``safe`` a 0-dim float32 tensor on x's device."""
    _build.refuse_grad("quant_table", x, safe)
    if not _on_card("quant_table", x):
        return quant_table_plain(x, safe, dtype)
    t = _int_dtype(dtype)
    if (x.dtype != torch.float32 or safe.dtype != torch.float32
            or safe.dim() != 0 or safe.device != x.device):
        raise ValueError("K-quant's table takes a float32 x and a 0-dim "
                         "float32 safe on its device")
    out = torch.empty(x.shape, dtype=t, device=x.device)
    vec = int(x.data_ptr() % 16 == 0
              and out.data_ptr() % (4 * out.element_size()) == 0)
    lib = _build.load("quant")
    with torch.cuda.device(x.device):
        err = lib.quant_table(x.data_ptr(), x.numel(), vec, safe.data_ptr(),
                              out.data_ptr(), TABLE_TYPES[t],
                              _build.stream_of(x))
    _build.check(err, "quant_table")
    _count("table")
    return out


def payload_route(x) -> str:
    """The payload kernel's loads for ``x`` (``csrc/quant.cu:
    payload_kernel``): ``16 / itemsize`` columns a 16-byte load where every
    such chunk lies whole in its row and x is 16-byte aligned, else 4-byte
    elements one by one, or narrower ones from the one or two aligned
    16-byte granules holding them; 64 x 64 tiles."""
    e = 16 // x.element_size()
    if x.shape[1] % e == 0 and x.data_ptr() % 16 == 0:
        how = "a 16-byte load"
    elif e == 4:
        how = "4 element loads"
    else:
        how = "a pair of 16-byte granules"
    return f"64x64 tiles, {e} columns {how}"


def payload_dims(w_max: int, h: int) -> "tuple[int, int]":
    """``(h_pad, k_pad)`` of K-int's payload for a core whose widest band
    is ``w_max`` at width ``h``: multiples of 64 and 16."""
    return -(-h // 64) * 64, -(-w_max // 16) * 16


def _check_payload(x, rows, safe, limbs, h_pad, k_pad) -> None:
    if x.dim() != 2 or x.dtype not in PAYLOAD_TYPES:
        raise ValueError(f"core_payload takes a float32, int8, int16 or int32 "
                         f"(N, H) x, got {x.dtype} {tuple(x.shape)}")
    if (safe is None) != (x.dtype != torch.float32):
        raise ValueError("core_payload rounds a float32 x by safe and takes "
                         "an integer x as it is")
    if rows.dim() != 1 or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError("core_payload's rows are a 1-D int32 or int64 tensor")
    if (not 1 <= limbs <= 4 or h_pad % 64 or h_pad < x.shape[1] or k_pad % 16
            or k_pad < rows.numel()):
        raise ValueError(f"core_payload: limbs 1..4, h_pad % 64 == 0 and >= H,"
                         f" k_pad % 16 == 0 and >= the rows; got {limbs}, "
                         f"{h_pad}, {k_pad} for H {x.shape[1]} and "
                         f"{rows.numel()} rows")


def core_payload_plain(x, rows, safe, limbs: int, h_pad: int, k_pad: int):
    """The gather, the rounding and the limb split as PyTorch ops."""
    xc = x.index_select(0, rows)
    if safe is not None:
        xc = torch.round(xc / safe).to(torch.int32)
    return limb_split(xc, limbs, h_pad, k_pad)


def core_payload(x, rows, safe, limbs: int, h_pad: int, k_pad: int):
    """K-int's payload ``(limbs, h_pad, k_pad)`` int8 of the rows
    ``x[rows]``: each ``q = round(x[r] / safe)`` (float32 x) or ``x[r]``
    (int8, int16, int32 x) as ``limbs`` balanced digits, digit l of row j,
    column n at ``[l, n, j]``; zero past the rows, past H and in the pads
    (module docstring). On the card any H and alignment, into a fresh
    output a call (the interleave runs the core on a second stream). The
    host's part of a call is kept to the checks, the output and the
    launch: int32 contiguous rows are taken as they are, and the device
    is switched only where x is not on the current one (``chip_smoke.py:payload_host_steps`` times each step)."""
    _check_payload(x, rows, safe, limbs, h_pad, k_pad)
    _build.refuse_grad("core_payload", x)
    if not _on_card("core_payload", x):
        return core_payload_plain(x, rows, safe, limbs, h_pad, k_pad)
    dev = x.device
    if rows.device != dev or (safe is not None and (
            safe.device != dev or safe.dtype != torch.float32
            or safe.dim() != 0)):
        raise ValueError("core_payload's rows and safe lie on x's device")
    if rows.dtype != torch.int32 or not rows.is_contiguous():
        rows = rows.to(torch.int32).contiguous()
    out = torch.empty((limbs, h_pad, k_pad), dtype=torch.int8, device=dev)
    lib = _build.load("quant")
    switch = dev.index is not None and dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        err = lib.quant_core_payload(
            x.data_ptr(), PAYLOAD_TYPES[x.dtype], rows.data_ptr(),
            rows.numel(), None if safe is None else safe.data_ptr(), limbs,
            x.shape[1], h_pad, k_pad, out.data_ptr(), _build.stream_of(x))
    _build.check(err, "quant_core_payload")
    _count("payload")
    return out
