"""K-bn: the training forward's BatchNorm → ReLU → dropout block and its
backward.

Counterpart of the XLA fusion, and its autodiff, that the reference's
training forward makes of ``pygim_tpu/nn/layers.py:batchnorm_train_apply``,
``jax.nn.relu`` and ``dropout`` (``pygim_tpu/nn/models.py:gnn_apply`` under
``pygim_tpu/nn/train.py:make_train_step``'s jit). Over ``z`` (N, H)
float32, per column::

    mean = mean(z), var = mean((z − mean)²)       (biased, two-pass: jnp.var)
    inv  = rsqrt(var + eps)
    out  = where(keep, relu((z − mean) · inv · γ + β) / (1 − rate), 0)

and its backward with ``g_b`` the gradient after the dropout and the ReLU
(``g / (1 − rate)`` where kept and the ReLU's output is above 0, else 0)
and ``x̂ = (z − mean) · inv``::

    dβ = Σ g_b,  dγ = Σ g_b · x̂
    dz = (γ · inv) · ((g_b − Σ g_b / N) − x̂ · Σ (g_b · x̂) / N)

(the batch mean and variance are returned detached, for the running
statistics, as the reference's ``stop_gradient`` does).

The mask (:func:`keep_mask`): element ``e = row · H + col`` is kept where
``(word >> 8) < t``, ``word`` the ``e % 4``-th output of Philox4x32-10
(:func:`philox4x32_10`) at counter ``(lo32(e / 4), hi32(e / 4), 0, 0)`` and
the dropout site's key, ``t = round((1 − rate) · 2^24)`` (:func:`keep_threshold`).
The key is two 32-bit words drawn from the caller's ``torch.Generator`` on
z's device (:func:`draw_key`); the kernels read it by pointer, so nothing
synchronises with the host, and recompute the mask in the backward: no
(N, H) mask is stored.

Four kernels in ``csrc/bn_train.cu`` and their plain versions here:
:func:`bn_stats` (:func:`bn_stats_plain`), :func:`bn_apply`
(:func:`bn_apply_plain`), :func:`bn_bwd_stats` (:func:`bn_bwd_stats_plain`)
and :func:`bn_bwd` (:func:`bn_bwd_plain`). A wrapper takes the plain
version for CPU tensors and launches the kernel for CUDA tensors, or
raises. :class:`BnReluDropout` is the autograd Function over the four, on
either device. Given the same statistics and key, ``bn_apply`` and
``bn_bwd`` equal their plain versions on the card bit for bit (every step
rounded alone, in the plain version's order; PyTorch on CUDA divides by a
Python scalar as a multiply by its f32 reciprocal, which the kernels take
as ``scale``); the statistics and the backward's column sums are sums in
another order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pygim_tpu_torch.ops import _build

# kernel launches since the last reset, by kernel (plain ints; launches only)
launches = dict.fromkeys(("stats", "fwd", "bwd stats", "bwd"), 0)

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
# rows of a chunk in the reductions' partial sums (at most MAX_CHUNKS
# chunks, each of ceil(n / chunks) rows as the kernels cut them)
CHUNK_ROWS = 256
MAX_CHUNKS = 65535


# ------------------------------------------------------------------ the mask

def _mulhilo(m: int, c):
    """``(hi, lo)`` 32-bit halves of ``m · c`` for a 32-bit constant ``m``
    and an int64 tensor ``c`` of 32-bit words, in 48-bit partial products
    (nothing overflows int64)."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    return (b + (a >> 16)) >> 16, (a + ((b & 0xFFFF) << 16)) & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123's constants) over int64 tensors:
    ``counter`` (..., 4) and ``key`` (2,) of 32-bit words; returns the (...,
    4) output words, int64 in [0, 2^32)."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key[0], key[1]
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), -1)


def keep_threshold(rate: float) -> int:
    """``t`` of the keep test ``(word >> 8) < t``: ``round((1 − rate) ·
    2^24)``, for a rate in [0, 1)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return int(round((1.0 - rate) * (1 << 24)))


def keep_scale(rate: float) -> float:
    """The kept elements' factor as the kernels take it: ``1 / (1 −
    rate)`` rounded to float32 from the float32 ``1 − rate``, as PyTorch on
    CUDA divides a tensor by a Python scalar."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def draw_key(generator: torch.Generator, device) -> torch.Tensor:
    """A dropout site's key: two 32-bit words (int64) drawn from
    ``generator`` onto ``device``."""
    return torch.randint(0, 1 << 32, (2,), generator=generator,
                         device=device)


def keep_mask(key, shape, rate: float):
    """The dropout mask of ``shape`` for ``key`` at ``rate`` (bool, True
    where kept), on key's device: word ``e % 4`` of Philox4x32-10 at
    counter ``(lo32(e / 4), hi32(e / 4), 0, 0)`` for element ``e`` of the
    row-major flattening, kept where ``(word >> 8) < keep_threshold(rate)``."""
    numel = math.prod(shape)
    q = torch.arange(-(-numel // 4), dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(q)
    words = philox4x32_10(torch.stack((q & _MASK32, q >> 32, zero, zero), -1),
                          key.to(torch.int64))
    return ((words.reshape(-1)[:numel] >> 8)
            < keep_threshold(rate)).reshape(shape)


# ------------------------------------------------------- the plain versions

def bn_stats_plain(z):
    """``(mean, var)`` of z's columns, float32: the mean as ``z.mean(0)``,
    the biased variance two-pass (``mean((z − mean)²)``, as ``jnp.var``)
    summed in float64, which rounds to the float32 that ``z.var(0,
    unbiased=False)`` gives on the CPU (it accumulates in float64): on the
    CPU the block's forward equals the unfused chain's bit for bit. An
    error of 1e-7 of a variance would reach 6e-5 of a GIN's logits through
    its deeper BatchNorms."""
    mean = z.mean(0)
    zd = z.double()
    return mean, (zd - zd.mean(0)).square().mean(0).float()


def bn_apply_plain(z, mean, inv, gamma, beta, key, rate: float):
    """``relu((z − mean) · inv · γ + β)``, then the inverted dropout
    ``where(keep_mask(key), y / (1 − rate), 0)`` where ``key`` is not None
    (None: no dropout)."""
    y = torch.relu((z - mean) * inv * gamma + beta)
    if key is None:
        return y
    keep = keep_mask(key, z.shape, rate)
    return torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))


def _grad_b(g, xhat, gamma, beta, key, rate: float):
    """g through the dropout's and the ReLU's backward, as autograd takes
    it through :func:`bn_apply_plain`: ``g / (1 − rate)`` where kept, 0
    where dropped or where the ReLU's output is <= 0 (a NaN passes, as in
    ``torch.relu``'s backward)."""
    drop = xhat * gamma + beta <= 0
    if key is not None:
        drop = drop | ~keep_mask(key, g.shape, rate)
        g = g / (1.0 - rate)
    return torch.where(drop, torch.zeros_like(g), g)


def bn_bwd_stats_plain(g, z, mean, inv, gamma, beta, key, rate: float):
    """``(Σ g_b, Σ g_b · x̂)`` over rows: ``g_b`` is g after the dropout's
    and the ReLU's backward (the mask and the ReLU's sign recomputed from
    z), ``x̂ = (z − mean) · inv``. They are dβ and dγ."""
    xhat = (z - mean) * inv
    gb = _grad_b(g, xhat, gamma, beta, key, rate)
    return gb.sum(0), (gb * xhat).sum(0)


def bn_bwd_factors(gamma, inv, n: int, sum_gb, sum_gbx):
    """dz's per-column factors ``(a, m_b, m_x)``: ``a = γ · inv``, ``m_b =
    a · (Σ g_b / N)``, ``m_x = a · (Σ g_b · x̂ / N)``, the same ops for the
    kernel and the plain version."""
    a = gamma * inv
    return a, a * (sum_gb / n), a * (sum_gbx / n)


def bn_bwd_plain(g, z, mean, inv, gamma, beta, key, rate: float, sum_gb,
                 sum_gbx):
    """dz of the block, in this order of f32 ops: ``x̂ = (z − mean) · inv``,
    ``g_b`` as :func:`bn_bwd_stats_plain`, the per-column ``a``, ``m_b``,
    ``m_x`` of :func:`bn_bwd_factors` from the sums given, then ``(a · g_b −
    m_b) − x̂ · m_x``: four roundings an element, each term at dz's scale."""
    xhat = (z - mean) * inv
    gb = _grad_b(g, xhat, gamma, beta, key, rate)
    a, m_b, m_x = bn_bwd_factors(gamma, inv, z.shape[0], sum_gb, sum_gbx)
    return (a * gb - m_b) - xhat * m_x


# ----------------------------------------------------------------- wrappers

def _check(what, z, cols=(), key=None, others=()):
    """z float32 (N ≥ 1, H); ``others`` (g) z's shape and dtype; ``cols``
    float32 (H,) on z's device; ``key`` int64 (2,) there. Returns (n, h)."""
    if z.dim() != 2 or z.dtype != torch.float32 or z.shape[0] < 1:
        raise ValueError(f"{what} takes a float32 (N, H) input with N >= 1, "
                         f"got {z.dtype} {tuple(z.shape)}")
    for t in others:
        if t.shape != z.shape or t.dtype != z.dtype or t.device != z.device:
            raise ValueError(f"{what}: the gradient must match z "
                             f"{tuple(z.shape)} float32 on {z.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n, h = z.shape
    for t in cols:
        if (t.shape != (h,) or t.dtype != torch.float32
                or t.device != z.device):
            raise ValueError(f"{what}'s per-column parameters are float32 "
                             f"({h},) on z's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if key is not None and (key.shape != (2,) or key.dtype != torch.int64
                            or key.device != z.device):
        raise ValueError(f"{what}'s key is an int64 (2,) tensor on z's "
                         f"device, got {key.dtype} {tuple(key.shape)} on "
                         f"{key.device}")
    return n, h


def _dispatch(what, z, tensors) -> bool:
    """True for the kernel (CUDA tensors, contiguous), False for the plain
    version (CPU tensors); raises on another device, a non-contiguous CUDA
    tensor, or an operand that requires grad under grad mode."""
    _build.refuse_grad(what, *tensors)
    if z.device.type == "cpu":
        return False
    if z.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {z.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous CUDA tensors")
    return True


def _vec(h: int, *tensors) -> int:
    return int(h % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _chunks(n: int) -> int:
    """The reductions' chunk count for n rows: at most MAX_CHUNKS, of about
    CHUNK_ROWS rows each, and none empty (where the cap binds, ceil(n /
    cap) rows a chunk would leave the last chunks of the cap without a
    row)."""
    rows = -(-n // min(-(-n // CHUNK_ROWS), MAX_CHUNKS))
    return -(-n // rows)


def _drop_args(key, rate: float):
    """``(key pointer, t, scale)`` for the kernels; no dropout where
    ``key`` is None."""
    if key is None:
        return None, 0, 1.0
    return key.data_ptr(), keep_threshold(rate), keep_scale(rate)


def bn_stats(z, chunks: int | None = None):
    """``(mean, var)`` of z's columns (:func:`bn_stats_plain`): K-bn stats
    on the card, over ``chunks`` chunks of rows (default :func:`_chunks`;
    1 to min(n, MAX_CHUNKS))."""
    what = "K-bn stats"
    n, h = _check(what, z)
    if not _dispatch(what, z, (z,)):
        return bn_stats_plain(z)
    chunks = _chunks(n) if chunks is None else chunks
    partials = torch.empty((chunks, h, 2), dtype=torch.float64,
                           device=z.device)
    mean = torch.empty(h, dtype=torch.float32, device=z.device)
    var = torch.empty_like(mean)
    lib = _build.load("bn_train")
    with torch.cuda.device(z.device):
        err = lib.bn_stats(z.data_ptr(), n, h, _vec(h, z), chunks,
                           partials.data_ptr(), mean.data_ptr(),
                           var.data_ptr(), _build.stream_of(z))
    _build.check(err, what)
    launches["stats"] += 1
    return mean, var


def bn_apply(z, mean, inv, gamma, beta, key, rate: float):
    """The block's forward value (:func:`bn_apply_plain`): K-bn fwd on the
    card, one read of z and one write."""
    what = "K-bn fwd"
    cols = (mean, inv, gamma, beta)
    n, h = _check(what, z, cols, key)
    if not _dispatch(what, z, (z, *cols)):
        return bn_apply_plain(z, mean, inv, gamma, beta, key, rate)
    out = torch.empty_like(z)
    kp, t, s = _drop_args(key, rate)
    lib = _build.load("bn_train")
    with torch.cuda.device(z.device):
        err = lib.bn_fwd(z.data_ptr(), out.data_ptr(), n, h,
                         _vec(h, z, out, *cols), mean.data_ptr(),
                         inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                         kp, t, s, _build.stream_of(z))
    _build.check(err, what)
    launches["fwd"] += 1
    return out


def bn_bwd_stats(g, z, mean, inv, gamma, beta, key, rate: float):
    """``(Σ g_b, Σ g_b · x̂)`` (:func:`bn_bwd_stats_plain`): K-bn bwd stats
    on the card."""
    what = "K-bn bwd stats"
    cols = (mean, inv, gamma, beta)
    n, h = _check(what, z, cols, key, (g,))
    if not _dispatch(what, z, (g, z, *cols)):
        return bn_bwd_stats_plain(g, z, mean, inv, gamma, beta, key, rate)
    chunks = _chunks(n)
    partials = torch.empty((chunks, h, 2), dtype=torch.float64,
                           device=z.device)
    sum_gb = torch.empty(h, dtype=torch.float32, device=z.device)
    sum_gbx = torch.empty_like(sum_gb)
    kp, t, s = _drop_args(key, rate)
    lib = _build.load("bn_train")
    with torch.cuda.device(z.device):
        err = lib.bn_bwd_stats(g.data_ptr(), z.data_ptr(), n, h,
                               _vec(h, g, z, *cols), mean.data_ptr(),
                               inv.data_ptr(), gamma.data_ptr(),
                               beta.data_ptr(), kp, t, s, chunks,
                               partials.data_ptr(), sum_gb.data_ptr(),
                               sum_gbx.data_ptr(), _build.stream_of(z))
    _build.check(err, what)
    launches["bwd stats"] += 1
    return sum_gb, sum_gbx


def bn_bwd(g, z, mean, inv, gamma, beta, key, rate: float, sum_gb, sum_gbx):
    """dz (:func:`bn_bwd_plain`): K-bn bwd on the card, one read each of z
    and g and one write."""
    what = "K-bn bwd"
    cols = (mean, inv, gamma, beta, sum_gb, sum_gbx)
    n, h = _check(what, z, cols, key, (g,))
    if not _dispatch(what, z, (g, z, *cols)):
        return bn_bwd_plain(g, z, mean, inv, gamma, beta, key, rate, sum_gb,
                            sum_gbx)
    factors = bn_bwd_factors(gamma, inv, n, sum_gb, sum_gbx)
    dz = torch.empty_like(z)
    kp, t, s = _drop_args(key, rate)
    lib = _build.load("bn_train")
    with torch.cuda.device(z.device):
        err = lib.bn_bwd(g.data_ptr(), z.data_ptr(), dz.data_ptr(), n, h,
                         _vec(h, g, z, dz, *cols, *factors), mean.data_ptr(),
                         inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                         kp, t, s, *(f.data_ptr() for f in factors),
                         _build.stream_of(z))
    _build.check(err, what)
    launches["bwd"] += 1
    return dz


class BnReluDropout(torch.autograd.Function):
    """``(out, mean, var) = BnReluDropout.apply(z, γ, β, key, rate, eps)``:
    the block's value (:func:`bn_stats`, then :func:`bn_apply` with ``inv =
    rsqrt(var + eps)``) and its batch statistics, detached. It saves z,
    mean, inv, γ, β and the key (no mask, no ReLU sign), and its backward
    runs :func:`bn_bwd_stats` and :func:`bn_bwd`: dz, dγ = Σ g_b · x̂, dβ =
    Σ g_b. ``key`` None: no dropout. Each piece is the kernel on the card
    and the plain version on the CPU."""

    @staticmethod
    def forward(ctx, z, gamma, beta, key, rate, eps):
        z = z.contiguous()
        mean, var = bn_stats(z)
        inv = torch.rsqrt(var + eps)
        out = bn_apply(z, mean, inv, gamma, beta, key, rate)
        ctx.save_for_backward(z, mean, inv, gamma, beta, key)
        ctx.rate = rate
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _g_mean, _g_var):
        z, mean, inv, gamma, beta, key = ctx.saved_tensors
        g = g.contiguous()
        sum_gb, sum_gbx = bn_bwd_stats(g, z, mean, inv, gamma, beta, key,
                                       ctx.rate)
        dz = None
        if ctx.needs_input_grad[0]:
            dz = bn_bwd(g, z, mean, inv, gamma, beta, key, ctx.rate, sum_gb,
                        sum_gbx)
        return dz, sum_gbx, sum_gb, None, None, None
