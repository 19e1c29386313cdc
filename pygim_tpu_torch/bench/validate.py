"""Numerical validation of the forward, per layer: the counterpart of
``pygim_tpu/bench/validate.py``.

:func:`validate_inference_sampled` is the check that runs at any graph
size: the real forward, one layer at a time, with an aggregate that keeps
only what the check needs of each call (the sampled output rows, the
input rows of their neighbours and the input's max|v|), then those rows
recomputed on the host from the CSR in float64, with the fused
quantization replicated where the aggregate quantizes. Only one (N, H)
activation and the one being made exist at a time. The smaller
:func:`validate_model` and :func:`validate_backend` compare whole
activations and products, for graphs that fit twice over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.nn.models import forward_block, forward_stem
from pygim_tpu_torch.ops.spmm import PreparedAggregate, SpmmConfig, prepare_spmm
from pygim_tpu_torch.quant import _SCALE_EXP
from pygim_tpu_torch.utils.metrics import DataReporter


def layer_activations(model, x, aggregate) -> "list[np.ndarray]":
    """The activation after every stage of ``model``'s evaluation forward
    (input projection, each conv block, output head), as numpy arrays:
    the stages of ``nn/models.py:gnn_apply``, fused as it fuses them."""
    acts = []
    with torch.inference_mode():
        h = forward_stem(model, x, fused=True)
        acts.append(h.cpu().numpy())
        for i in range(len(model.convs)):
            h = forward_block(model, i, h, aggregate, fused=True)
            acts.append(h.cpu().numpy())
        acts.append(model.ln2(h).cpu().numpy())
    return acts


def validate_model(model, x, aggregate, oracle_aggregate, *,
                   rtol: float = 1e-4, atol: float = 1e-4,
                   reporter: Optional[DataReporter] = None) -> bool:
    """Per-layer activations of ``aggregate`` against ``oracle_aggregate``:
    reports ``layer{i}_max_err`` and ``validate`` (OK / ERROR)."""
    rep = reporter or DataReporter(echo=False)
    got = layer_activations(model, x, aggregate)
    ref = layer_activations(model, x, oracle_aggregate)
    ok = True
    for i, (g, r) in enumerate(zip(got, ref)):
        err = float(np.max(np.abs(g - r))) if g.size else 0.0
        rep.report(f"layer{i}_max_err", err)
        scale = max(1.0, float(np.max(np.abs(r)))) if r.size else 1.0
        if err > atol + rtol * scale:
            ok = False
    rep.report("validate", "OK" if ok else "ERROR")
    return ok


def validate_backend(graph, hidden: int, config: SpmmConfig, *,
                     n_check_cols: int = 32, seed: int = 0,
                     rtol: float = 1e-4, atol: float = 1e-4,
                     device="cuda") -> bool:
    """The whole product of ``config`` against the oracle backend on a
    random float32 operand of ``min(hidden, n_check_cols)`` columns."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(
        rng.standard_normal((graph.ncols, min(hidden, n_check_cols))),
        dtype=torch.float32).to(device)
    got = prepare_spmm(graph, config, device=device).mul(x).cpu().numpy()
    ref = prepare_spmm(graph, SpmmConfig(backend="oracle"),
                       device=device).mul(x).cpu().numpy()
    return np.allclose(got, ref, rtol=rtol, atol=atol)


# The reference's validation adapter: ``prep.mul`` and the fused hook
# ``prep.mul_quantized`` where the backend fuses (None elsewhere, so the
# caller takes the round trip), i.e. the timed forward's own products.
# PyTorch runs eagerly, so it is the prepared operand's own aggregate.
JittedAggregate = PreparedAggregate


class _CaptureAggregate:
    """Wraps an aggregate and keeps, of each call, only the sampled output
    rows, the sampled neighbours' input rows and the input's max|v| (on
    the host), with the quantization dtype of a fused call (None for a
    plain one). It offers the fused hooks the forward probes
    (``quantized_raw``, ``quantized``) where the wrapped aggregate has
    them, so the check sees the timed forward's own products; of an
    undequantized product it keeps the sampled rows times the scale."""

    def __init__(self, base, rows_idx, nbr_idx):
        self._base, self._rows, self._nbr = base, rows_idx, nbr_idx
        self.capture: list = []

    def _rec(self, v, out, qname, sampled=False) -> None:
        self.capture.append((
            (out if sampled else out.index_select(0, self._rows)).cpu().numpy(),
            v.index_select(0, self._nbr).cpu().numpy(),
            float(torch.linalg.vector_norm(v, float("inf"))
                  if v.is_floating_point() else v.abs().max()),
            qname,
        ))

    def __call__(self, v):
        out = self._base(v)
        self._rec(v, out, None)
        return out

    def quantized(self, v, agg_dtype: str):
        fused = getattr(self._base, "quantized", None)
        out = None if fused is None else fused(v, agg_dtype)
        if out is not None:
            self._rec(v, out, agg_dtype)
        return out

    def quantized_raw(self, v, agg_dtype: str):
        raw = getattr(self._base, "quantized_raw", None)
        got = None if raw is None else raw(v, agg_dtype)
        if got is not None:
            out, scale = got
            self._rec(v, out.index_select(0, self._rows) * scale, agg_dtype,
                      sampled=True)
        return got


def validate_inference_sampled(graph, model, x, aggregate, *,
                               rows_to_check: int = 128, seed: int = 0,
                               rtol: float = 1e-2, atol: float = 1e-3,
                               reporter: Optional[DataReporter] = None
                               ) -> bool:
    """Per-layer aggregate validation at any scale
    (``pygim_tpu/bench/validate.py:164-290``): the forward of ``model`` on
    ``x`` through ``aggregate`` (a :class:`JittedAggregate`), one layer at
    a time, each aggregate's ``rows_to_check`` sampled output rows held
    against the same rows recomputed from the host CSR in float64. A
    fused quantized aggregate (int8, int16, int32) is held against a
    host replica of its quantization: ``scale = 2 · max|v| / 2^k`` in
    float32 (1 where it is 0), ``round(v / scale)``, the integer sum,
    ``· scale``. A row passes within ``atol + rtol · max(1, max|ref|)``.
    Reports ``agg{i}_max_rel_err`` (the worst ``|err| / max(1, max|ref|)``
    of each aggregate) and ``validate`` (OK / ERROR); returns whether
    every row passed."""
    rep = reporter or DataReporter(echo=False)
    csr = graph if hasattr(graph, "rowptr") else graph.to_csr()
    rng = np.random.default_rng(seed)
    rows = np.sort(
        rng.choice(csr.nrows, min(rows_to_check, csr.nrows), replace=False))
    segs = [(int(csr.rowptr[r]), int(csr.rowptr[r + 1])) for r in rows]
    off = np.concatenate([[0], np.cumsum([e1 - e0 for e0, e1 in segs])])
    nbr = (np.concatenate([csr.colind[e0:e1] for e0, e1 in segs])
           if off[-1] else np.zeros(1, dtype=np.int32))
    ew = (np.concatenate([csr.vals[e0:e1] for e0, e1 in segs])
          if off[-1] else np.zeros(0, dtype=csr.vals.dtype))
    dev = x.device
    rows_idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
    nbr_idx = torch.as_tensor(nbr, dtype=torch.int64, device=dev)

    capture = []
    with torch.inference_mode():
        # the timed forward's stages (nn/models.py:gnn_apply), fused alike
        h = forward_stem(model, x, fused=True)
        for i in range(len(model.convs)):
            cap = _CaptureAggregate(aggregate, rows_idx, nbr_idx)
            h2 = forward_block(model, i, h, cap, fused=True)
            del h  # one activation and the one being made
            h = h2
            capture.extend(cap.capture)
        del h

    ok = True
    for li, (g_out, g_in, in_absmax, qname) in enumerate(capture):
        if qname is not None:
            k = _SCALE_EXP[qname]
            q_scale = (np.float32(in_absmax) * np.float32(2.0)
                       / np.float32(2.0 ** k))
            q_scale = q_scale if q_scale != 0 else np.float32(1.0)
        max_err = 0.0
        for i in range(rows.size):
            s0, s1 = int(off[i]), int(off[i + 1])
            vrows = g_in[s0:s1].astype(np.float64)
            if qname is not None:
                vrows = np.round(vrows.astype(np.float32) / q_scale
                                 ).astype(np.float64)
            ref = (vrows * ew[s0:s1, None].astype(np.float64)).sum(axis=0)
            if qname is not None:
                ref = ref * np.float64(q_scale)
            err = float(np.max(np.abs(g_out[i].astype(np.float64) - ref)))
            scale = max(1.0, float(np.max(np.abs(ref))))
            max_err = max(max_err, err / scale)
            if err > atol + rtol * scale:
                ok = False
        rep.report(f"agg{li}_max_rel_err", max_err)
    rep.report("validate", "OK" if ok else "ERROR")
    return ok
