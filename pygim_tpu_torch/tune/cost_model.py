"""The card's cost model for SpMM configuration search: the port's twin of
``pygim_tpu/tune/cost_model.py``, priced with this card's own constants.

:func:`predict_spmm_time` keeps the reference's phase structure on the
statistics of :func:`pygim_tpu_torch.tune.autotuner.plan_statistics`:

    bytes = gather_bytes / (hbm · gather_eff) + stream_bytes / (hbm ·
            stream_eff) + scatter_bytes / (hbm · scatter_eff)
    tail  = bytes (blocked), or max(bytes, ELL issue time) for an ELL tail
            (the ELL issue time alone where ``tail_roofline`` is off);
            blocked with ``rows_factor`` > 0 (the measured model):
            K-rows, rows_factor × the ELL issue time of its entries
            (n_blocks · nnz_pad) and rows (n_blocks · rows_pad)
    core  = max(core_bytes / (hbm · stream_eff), core_flops / core rate)
            / core_eff
    bcsr  = max(bcsr_stream_bytes / (hbm · stream_eff), bcsr_flops / tile rate)
    + collective volume, n_dispatch · fixed_us        # none on one card
    + launches · launch_us                            # the port's own term

The ELL issue time is ``slots · ell_slot_ns · ell_slot_factor + vrows ·
(ell_vrow_fixed_ns + H · ell_vrow_ns_per_h)`` (the reference reads these
constants from its planner; here they are fields). Fitted to K-tail on the
card, it is K-tail's whole time, bytes included, and the measured model
prices the tail by it alone (``tail_roofline`` False): the byte roofline
reads every slot's row from HBM at the rate of a gather without reuse,
where K-tail on a real graph finds many rows in the L2. The core's rate
follows its cells as the port runs them: bf16 ``wgmma`` for int8, int4
and bf16 cells (K-core), three TF32 products at half that rate for f32
cells (K-f32); ``core_eff`` is the share of that roofline K-core reaches.
A BCSR tier's bf16 tiles run at the bf16 rate, its f32 tiles at
``tensor_f32`` (K-bcsr's 3xTF32 route, three TF32 products a term as
K-f32's). ``scatter_bytes`` is the reference's materialized gather of the
``blocked`` body; the port's ``blocked`` runs K-rows
(``ops/seg_rows.py``), which gathers each entry's x row into registers
and writes each output row once: K-tail's work on one-entry slots. So
the measured model prices it as K-tail's fitted issue time of its
entries and rows times ``rows_factor``: K-rows' time on an R-MAT graph
over that issue time there. K-rows walks rows in their own order, and a
power-law graph's neighbouring rows share x rows in the L2, which a
uniform table (K-tail's fit) never does: the factor carries that reuse.
Its ``scatter_eff`` is ``stream_eff`` (the reference's convention: no
pass of the port reads the scatter bytes). ``launches`` counts the PyTorch
ops and kernel launches the port's run path dispatches.

Where the constants come from (``provenance``):

* :meth:`CardCostModel.default` — this card's measured constants where
  they are cached for this card and power limit, else the data sheet of
  the visible card (or of the H100 SXM where none is visible), with every
  efficiency 1 and the ELL issue, launch and dispatch terms 0:
  uncalibrated.
* :func:`measure_constants` — measured on the card with CUDA events
  (:func:`~pygim_tpu_torch.utils.timers.device_time`): a stream copy and
  a row gather (PyTorch ops: they read the memory, not a kernel of the
  port), K-tail on uniform ELL tables at two degrees and two widths (the
  ELL issue constants), K-rows' C entry point on a tiny table, called
  back to back (``launch_us``: a launch with nothing to do), the
  ``blocked`` product (K-rows) on an R-MAT graph of :data:`ROWS_GRAPH`
  at H 256 (``rows_factor``: its time over the fitted ELL issue time of
  its entries and rows, a ratio of two positive times), a tiny ``ell``
  product (``fixed_us``) and K-core on a 1 GiB int8 band
  (``core_eff``). The stream copy, the gather and K-core each read the
  fastest of :data:`BEST_OF` runs. No efficiency is clipped: one above 1
  is a measurement to question.
  Cached as ``card_constants.json`` under
  ``$PYGIM_TPU_TORCH_TUNE_CACHE`` (default ``~/.cache/pygim_tpu_torch``)
  with the card's ``nvidia-smi`` line: a file of another card or power
  limit is not read.

* :func:`measure_ici_constants` — each collective of the port's meshes
  (``parallel/collectives.py``: ``psum``, ``all_gather``, ``all_to_all``,
  ``ppermute`` as the ``ring``'s one shift) timed over the given devices
  at two payloads and fitted to ``{"bw", "fixed_us"}`` in the volume units
  of ``plan_statistics`` (:func:`fit_collective`,
  :func:`collective_volume`), with the host clock and every device
  synchronized around the timed calls (one card's CUDA events do not wait
  for another card). :meth:`CardCostModel.for_topology` adds them to the
  measured model and ``+ici:<tag>x<n>`` to its provenance: the tag is
  ``cuda`` (distinct cards), ``cuda-virtual`` (one card repeated: the
  transfers are no-ops and the fit prices on-card index copies, not
  NVLink) or ``cpu``. Cached as ``ici-<tag>-n<n>.json`` under the same
  directory, with the card's line and the tag in its ``__meta``: a file
  of another card, or of a virtual mesh for real cards, is not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

from pygim_tpu_torch.core.partition import ell_issue_seconds

CONSTANTS_FILE = "card_constants.json"
# the layout of the measured constants: 2 since the blocked family runs on
# K-rows (``rows_factor``; ``launch_us`` and ``scatter_eff`` read afresh),
# 3 since f32 tiles run on K-bcsr's 3xTF32 route (priced at
# ``tensor_f32``; the FFMA mode's ``simt_f32`` is gone) and K-rows' wrapper
# was trimmed (``rows_factor`` and ``fixed_us`` measured again). A file of
# another version was fitted on other bodies and is measured again.
CONSTANTS_VERSION = 3
# the card assumed for the data sheet where none is visible: the H100 SXM,
# as torch names it
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"
# NVLink 4 on the H100 SXM, one direction (NVIDIA's data sheet: 900 GB/s
# both ways). No single-card plan moves a byte over it (psum_bytes 0).
NVLINK_BW = 450e9


def cache_dir() -> Path:
    """The tuner's cache: ``$PYGIM_TPU_TORCH_TUNE_CACHE``, default
    ``~/.cache/pygim_tpu_torch`` (never the reference's)."""
    return Path(os.environ.get(
        "PYGIM_TPU_TORCH_TUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "pygim_tpu_torch"),
    ))


@dataclasses.dataclass(frozen=True)
class CardCostModel:
    """The reference's fields (``tensor_bf16`` is its ``mxu_bf16``), the
    ELL issue constants it reads from its planner, the rates of f32 core
    cells and f32 tiles, the scatter's and the core's efficiencies, the
    launch cost, and whether the tail takes its byte roofline as a floor.
    With the reference's constants, ``scatter_eff = stream_eff``,
    ``core_eff = 1``, ``launch_us = 0``, ``tail_roofline`` on and
    ``rows_factor = 0``, it is the reference's model."""

    hbm_bw: float            # bytes/s
    ici_bw: float            # bytes/s a link direction
    gather_eff: float        # random-row gather rate / hbm_bw
    stream_eff: float        # streaming rate / hbm_bw
    scatter_eff: float       # the reference's scatter pass / hbm_bw
    fixed_us: float          # one product's fixed cost beyond its launches
    tensor_bf16: float       # FLOP/s: int8, int4, bf16 core cells, bf16 tiles
    tensor_f32: float        # FLOP/s of f32 core cells and f32 tiles (3xTF32)
    ell_slot_ns: float
    ell_vrow_fixed_ns: float
    ell_vrow_ns_per_h: float
    launch_us: float = 0.0   # one dispatched PyTorch op or kernel launch
    core_eff: float = 1.0    # K-core's share of the core's roofline
    tail_roofline: bool = True  # the tail at least its byte roofline
    rows_factor: float = 0.0  # K-rows / the ELL issue time (0: the bytes)
    coll: Optional[dict] = None
    ell_slot_factor: float = 1.0
    provenance: str = "datasheet"

    @classmethod
    def default(cls) -> "CardCostModel":
        """This card's measured constants where cached, else its data
        sheet (uncalibrated)."""
        card = visible_card()
        if card is not None:
            cached = load_measured(card)
            if cached is not None:
                return cached
        return datasheet(card)

    @classmethod
    def measured(cls, device="cuda") -> "CardCostModel":
        """The cached constants of this card, or measured now and cached
        (:func:`measure_constants`; raises without a card)."""
        card = visible_card()
        cached = load_measured(card) if card is not None else None
        return cached if cached is not None else measure_constants(device)

    @classmethod
    def for_topology(cls, n_devices: int, devices=None) -> "CardCostModel":
        """:meth:`measured` with the collectives' constants measured over
        the first ``n_devices`` of ``devices`` (default: the visible
        cards; :func:`measure_ici_constants`) and ``+ici:<tag>x<n>`` added
        to its provenance. One device, or fewer devices than
        ``n_devices`` (no mesh to time), gives :meth:`measured` alone: its
        collectives priced at ``ici_bw``."""
        import torch

        from pygim_tpu_torch.parallel.mesh import visible_cards

        devices = [torch.device(d) for d in (
            visible_cards() if devices is None else devices)]
        base = cls.measured(devices[0] if devices else "cuda")
        if n_devices <= 1 or len(devices) < n_devices:
            return base
        coll = measure_ici_constants(devices[:n_devices], save=True)
        meta = coll["__meta"]
        return dataclasses.replace(
            base, coll=coll,
            provenance=(f"{base.provenance}+ici:{meta['platform']}"
                        f"x{meta['n_devices']}"))


def visible_card() -> Optional[str]:
    """The first card's ``nvidia-smi`` line, or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    from pygim_tpu_torch.utils.device import card_line

    return card_line()


def datasheet(card: Optional[str] = None) -> CardCostModel:
    """The data sheet of the visible card (``card``: its ``nvidia-smi``
    line) or, where none is visible, of the H100 SXM: HBM and tensor
    rates at full power, efficiencies 1, no issue, launch or dispatch
    cost."""
    from pygim_tpu_torch.utils.device import peaks

    if card is None:
        name, where = DEFAULT_CARD, "no card visible"
    else:
        # nvidia-smi's line: "<name>, <power limit>"
        name, where = card.rsplit(",", 1)[0].strip(), card
    hbm, bf16, _f32, _int8 = peaks(name)
    return CardCostModel(
        hbm_bw=hbm, ici_bw=NVLINK_BW, gather_eff=1.0, stream_eff=1.0,
        scatter_eff=1.0, fixed_us=0.0, tensor_bf16=bf16, tensor_f32=bf16 / 6,
        ell_slot_ns=0.0, ell_vrow_fixed_ns=0.0, ell_vrow_ns_per_h=0.0,
        provenance=f"datasheet:{name} ({where}; uncalibrated)",
    )


def load_measured(card: str) -> Optional[CardCostModel]:
    """The cached measured constants where the file is this card's
    (``card``, its ``nvidia-smi`` line) and of :data:`CONSTANTS_VERSION`,
    else None."""
    path = cache_dir() / CONSTANTS_FILE
    if not path.exists():
        return None
    try:
        d = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if d.get("card") != card or d.get("version") != CONSTANTS_VERSION:
        return None
    return CardCostModel(**d["model"])


def save_measured(model: CardCostModel, card: str,
                  readings: Optional[dict] = None) -> Path:
    path = cache_dir() / CONSTANTS_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": card, "version": CONSTANTS_VERSION,
                                "model": dataclasses.asdict(model),
                                "readings": readings or {}}, indent=1))
    return path


COLLECTIVES = ("psum", "all_gather", "all_to_all", "ring")


def collective_volume(name: str, nd: int, rows: int, h: int) -> float:
    """Bytes of one ``name`` over ``nd`` devices with ``rows`` f32 rows of
    width ``h`` a device, in ``plan_statistics``' units (the reference's):
    ``psum`` ``rows·h·4·(nd−1)/nd·2``, ``all_gather`` ``(nd−1)·rows·h·4``,
    ``all_to_all`` the whole ``nd·rows·h·4`` buffer, ``ring`` one shift,
    ``rows·h·4``."""
    b = rows * h * 4
    return {"psum": b * (nd - 1) / nd * 2,
            "all_gather": (nd - 1) * b,
            "all_to_all": nd * b,
            "ring": b}[name]


def fit_collective(t1: float, t2: float, v1: float, v2: float) -> dict:
    """The reference's two-point fit of a collective timed ``t1`` s at
    volume ``v1`` and ``t2`` s at ``v2``: ``bw`` from the slope and
    ``fixed_us`` the small call's rest (at least 0); where the large call
    is not slower, ``bw = v2 / t2`` and no fixed cost."""
    if t2 > t1:
        bw = (v2 - v1) / (t2 - t1)
        fixed = max(0.0, t1 - v1 / bw)
    else:
        bw = v2 / max(1e-9, t2)
        fixed = 0.0
    return {"bw": float(bw), "fixed_us": float(fixed * 1e6)}


def mesh_tag(devices) -> str:
    """``cpu``, ``cuda`` (distinct cards) or ``cuda-virtual`` (a card
    repeated)."""
    import torch

    from pygim_tpu_torch.parallel.mesh import is_virtual

    devices = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devices):
        return "cpu"
    return "cuda-virtual" if is_virtual(devices) else "cuda"


def _ici_path(tag: str, nd: int, rows: int, h: int) -> Path:
    suffix = "" if (rows, h) == (4096, 256) else f"-r{rows}-h{h}"
    return cache_dir() / f"ici-{tag}-n{nd}{suffix}.json"


def _host_time(fn, devices, iters: int = 5) -> float:
    """Seconds a call of ``fn()`` on the host clock, every distinct device
    synchronized before and after the ``iters`` timed calls (after one
    warm call)."""
    import time

    import torch

    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def measure_ici_constants(devices, save: bool = True, rows: int = 4096,
                          h: int = 256) -> dict:
    """Per-collective ``{"bw": bytes/s, "fixed_us": µs}`` of the port's
    collectives over ``devices`` (module docstring): each timed with 8 and
    ``rows`` rows a device at width ``h`` (:func:`_host_time`) and fitted
    by :func:`fit_collective` on :func:`collective_volume`, plus an
    ``__meta`` entry (``platform``: :func:`mesh_tag`, ``n_devices``,
    ``card``, ``virtual``). Cached per tag, device count and card
    (``save``)."""
    import torch

    from pygim_tpu_torch.parallel import collectives as coll
    from pygim_tpu_torch.parallel.mesh import is_virtual

    devices = [torch.device(d) for d in devices]
    nd = len(devices)
    tag = mesh_tag(devices)
    card = visible_card() if tag != "cpu" else "cpu"
    path = _ici_path(tag, nd, rows, h)
    if save and path.exists():
        try:
            d = json.loads(path.read_text())
            if d.get("__meta", {}).get("card") == card:
                return d
        except (OSError, ValueError):
            pass

    def case(name, r):
        parts = [torch.ones((r, h), device=d) for d in devices]
        if name == "psum":
            return lambda: coll.psum(parts, devices[0])
        if name == "all_gather":
            return lambda: coll.all_gather(parts, devices)
        if name == "all_to_all":
            send = [torch.ones((nd, r, h), device=d) for d in devices]
            return lambda: coll.all_to_all(send, devices)
        return lambda: coll.ppermute(parts, 1, devices)

    out: dict = {}
    readings = {}
    for name in COLLECTIVES:
        t1 = _host_time(case(name, 8), devices)
        t2 = _host_time(case(name, rows), devices)
        out[name] = fit_collective(t1, t2, collective_volume(name, nd, 8, h),
                                   collective_volume(name, nd, rows, h))
        readings[name] = {"small_us": t1 * 1e6, "large_us": t2 * 1e6}
    out["__meta"] = {"platform": tag, "n_devices": nd, "card": card,
                     "virtual": is_virtual(devices), "rows": rows, "h": h,
                     "readings": readings}
    if save:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return out


def _core_rate(m: CardCostModel, cell: Optional[str]) -> float:
    return m.tensor_f32 if cell == "float32" else m.tensor_bf16


def predict_spmm_time(stats: dict,
                      model: Optional[CardCostModel] = None) -> float:
    """Predicted seconds of one SpMM under a plan's statistics (module
    docstring). On the reference's statistics with its constants and
    ``launch_us = 0`` it is the reference's ``predict_spmm_time``."""
    m = model or CardCostModel.default()
    if stats.get("ell_slots") is None and m.rows_factor > 0:
        # blocked on K-rows: K-tail's issue time of one-entry slots (the
        # entries) and virtual rows (the rows), scaled to K-rows
        tail_bw = m.rows_factor * ell_issue_seconds(
            stats["n_blocks"] * stats["nnz_pad"],
            stats["n_blocks"] * stats["rows_pad"], stats.get("ell_hidden"),
            slot_ns=m.ell_slot_ns * m.ell_slot_factor,
            vrow_fixed_ns=m.ell_vrow_fixed_ns,
            vrow_ns_per_h=m.ell_vrow_ns_per_h)
    else:
        tail_bw = (
            stats["gather_bytes"] / (m.hbm_bw * m.gather_eff)
            + stats["stream_bytes"] / (m.hbm_bw * m.stream_eff)
            + stats.get("scatter_bytes", 0) / (m.hbm_bw * m.scatter_eff)
        )
    if stats.get("ell_slots") is not None:
        issue = ell_issue_seconds(
            stats["ell_slots"], stats.get("ell_vrows") or 0,
            stats.get("ell_hidden"),
            slot_ns=m.ell_slot_ns * m.ell_slot_factor,
            vrow_fixed_ns=m.ell_vrow_fixed_ns,
            vrow_ns_per_h=m.ell_vrow_ns_per_h,
        )
        tail_bw = max(tail_bw, issue) if m.tail_roofline else issue
    t = tail_bw
    t += max(
        stats.get("core_bytes", 0) / (m.hbm_bw * m.stream_eff),
        stats.get("core_flops", 0) / _core_rate(m, stats.get("core_cell")),
    ) / m.core_eff
    tile_rate = (m.tensor_f32 if stats.get("bcsr_tile_dtype") == "float32"
                 else m.tensor_bf16)
    t += max(
        stats.get("bcsr_stream_bytes", 0) / (m.hbm_bw * m.stream_eff),
        stats.get("bcsr_flops", 0) / tile_rate,
    )
    cname = stats.get("collective")
    cinfo = (m.coll or {}).get(cname) if cname else None
    if cinfo is not None:
        t += stats["psum_bytes"] / max(1.0, cinfo["bw"])
        t += stats["n_dispatch"] * cinfo["fixed_us"] * 1e-6
        t += m.fixed_us * 1e-6
    else:
        t += stats["psum_bytes"] / m.ici_bw
        t += stats["n_dispatch"] * m.fixed_us * 1e-6
    t += stats.get("launches", 0) * m.launch_us * 1e-6
    return t


def calibrate_from_phases(
    stats: dict,
    phases_ms: dict,
    base: Optional[CardCostModel] = None,
    save: bool = False,
) -> CardCostModel:
    """Fit the gather and stream efficiencies from measured run-path phase
    times (:meth:`PreparedSpmm.phase_times`: ``gather_time(ms)``, the
    gather probe, and ``tail_time(ms)``, K-tail) and the plan's
    statistics, as the reference does. ``save`` caches the result as this
    card's constants (raises without a card)."""
    m = base or CardCostModel.default()
    kw = dataclasses.asdict(m)
    g = phases_ms.get("gather_time(ms)")
    t = phases_ms.get("tail_time(ms)")
    stream = stats["stream_bytes"] + stats.get("scatter_bytes", 0)
    if g and t and g >= t:
        # the gather probe slower than the whole tail: one effective
        # efficiency from the tail phase
        eff = max(
            1e-4,
            min(1.0, (stats["gather_bytes"] + stream) / (t * 1e-3)
                / kw["hbm_bw"]),
        )
        kw["gather_eff"] = kw["stream_eff"] = eff
    else:
        if g and g > 0 and stats.get("gather_bytes"):
            kw["gather_eff"] = max(
                1e-4,
                min(1.0, stats["gather_bytes"] / (g * 1e-3) / kw["hbm_bw"]),
            )
        if t and g is not None and t > g:
            kw["stream_eff"] = max(
                1e-4,
                min(1.0, stream / ((t - g) * 1e-3) / kw["hbm_bw"]),
            )
    model = CardCostModel(**kw)
    if save:
        card = visible_card()
        if card is None:
            raise RuntimeError("calibrate_from_phases(save=True): no CUDA "
                               "card to file the constants under")
        save_measured(model, card)
    return model


# K-tail's fit: uniform tables of TAIL_VROWS virtual rows, one output row
# each, over a TAIL_XROWS-row payload (1 GiB at H 256: no reuse in the
# 50 MB L2), at two degrees and two widths
TAIL_VROWS = 1 << 18
TAIL_XROWS = 1 << 20
TAIL_DEGREES = (4, 32)
TAIL_WIDTHS = (32, 256)
# K-core's efficiency: one int8 band of 1 GiB (the space's smallest core
# budget) at H 256, where it is bound by operations
CORE_BAND = 32768
# K-rows' probe: the blocked product of an R-MAT graph (nodes, stored
# edges, seed; the generator of the port's stand-ins) at H 256
ROWS_GRAPH = (1 << 18, 1 << 21, 1)


def fit_tail(times_ns: dict) -> dict:
    """The ELL issue constants from K-tail's time a virtual row,
    ``times_ns[(D, H)]`` in ns, at the two degrees and two widths:
    ``slot_ns`` from the degrees at the narrow width, the per-row cost
    ``V(H) = fixed + H · per_h`` from both widths at the small degree;
    the fourth point is the fit's check (``check_ns`` against
    ``times_ns``)."""
    (d1, d2), (h1, h2) = TAIL_DEGREES, TAIL_WIDTHS
    slot = (times_ns[(d2, h1)] - times_ns[(d1, h1)]) / (d2 - d1)
    v1 = times_ns[(d1, h1)] - d1 * slot
    v2 = times_ns[(d1, h2)] - d1 * slot
    per_h = (v2 - v1) / (h2 - h1)
    fixed = v1 - h1 * per_h
    return {"ell_slot_ns": slot, "ell_vrow_fixed_ns": fixed,
            "ell_vrow_ns_per_h": per_h,
            "check_ns": d2 * slot + fixed + h2 * per_h,
            "check_point": [d2, h2]}


def _card_device(device):
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure_constants: device {device!r}, but the "
                           "constants are measured on a CUDA card")
    return dev


def _tail_ns(dev, degree: int, h: int, gen) -> float:
    """K-tail's time a virtual row (ns) on a uniform table."""
    import numpy as np
    import torch

    from pygim_tpu_torch.ops.ell_tail import ell_tables_add, tail_plan
    from pygim_tpu_torch.utils.timers import device_time

    nvr, slots = TAIL_VROWS, TAIL_VROWS * degree
    x = torch.randn((TAIL_XROWS, h), device=dev, generator=gen)
    cols = torch.randint(0, TAIL_XROWS, (1, slots), device=dev,
                         generator=gen, dtype=torch.int32)
    vals = torch.ones((1, slots), device=dev)
    vrow = torch.arange(nvr, dtype=torch.int32, device=dev).view(1, nvr)
    tables = [(cols, vals, vrow, degree)]
    plan = tail_plan(tables, host=[(np.ones((1, slots), np.float32),
                                    np.arange(nvr, dtype=np.int32)[None])])
    out = torch.zeros((nvr, h), device=dev)
    t = device_time(lambda: ell_tables_add(x, tables, out, plan=plan),
                    iters=10)
    return t * 1e9 / nvr


def _launch_us(dev) -> float:
    """One kernel launch (µs): K-rows' C entry point called back to back
    on a tiny table (8 entries, 8 rows, H 8), its arguments prepared
    once: the cost of issuing a kernel, with nothing for it to do."""
    import numpy as np
    import torch

    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.ops.seg_rows import coo_plan
    from pygim_tpu_torch.utils.timers import device_time

    rows = torch.arange(8, dtype=torch.int32, device=dev)
    cols = torch.zeros(8, dtype=torch.int32, device=dev)
    vals = torch.ones(8, device=dev)
    x = torch.ones((8, 8), device=dev)
    out = torch.empty((8, 8), device=dev)
    plan = coo_plan(np.arange(8, dtype=np.int32), 8)
    d = plan.to(dev)
    lib = _build.load("seg_rows")
    args = (d["units"].data_ptr(), plan.n_units, d["hub_rows"].data_ptr(), 0,
            cols.data_ptr(), vals.data_ptr(), 0, rows.data_ptr(), None, 0, 0,
            x.data_ptr(), 0, 0, out.data_ptr(), 8, 1, _build.stream_of(x))

    def launch():
        _build.check(lib.seg_rows(*args), "seg_rows")
        return out

    with torch.cuda.device(dev):
        return device_time(launch, iters=100) * 1e6


def _rows_factor(dev, fit: dict) -> "tuple[float, float]":
    """The blocked product (K-rows) of the R-MAT graph :data:`ROWS_GRAPH`
    at H 256: ``(its time (s), that time over the ELL issue time of its
    entries and rows under the fitted constants`` ``fit`` (:func:`fit_tail`)
    ``)``."""
    import torch

    from pygim_tpu_torch.core.graph import CooGraph
    from pygim_tpu_torch.core.partition import ell_issue_seconds
    from pygim_tpu_torch.data.datasets import rmat_edges
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.utils.timers import device_time

    n, e, seed = ROWS_GRAPH
    rows, cols = rmat_edges(n, e, seed=seed)
    prep = prepare_spmm(CooGraph.from_edges(rows, cols, nrows=n, ncols=n),
                        SpmmConfig(), device=dev)
    x = torch.randn((n, 256), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    t = device_time(prep.mul, x, iters=10)
    plan = prep.plan
    issue = ell_issue_seconds(
        plan.n_blocks * plan.nnz_pad, plan.n_blocks * plan.rows_pad, 256,
        slot_ns=fit["ell_slot_ns"], vrow_fixed_ns=fit["ell_vrow_fixed_ns"],
        vrow_ns_per_h=fit["ell_vrow_ns_per_h"])
    return t, t / issue


def _fixed_us(dev, launch_us: float) -> float:
    """One tiny ``ell`` product's time beyond its launches (µs)."""
    import numpy as np
    import torch

    from pygim_tpu_torch.core.graph import CooGraph
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.tune.autotuner import RUN_OPS
    from pygim_tpu_torch.utils.timers import device_time

    rng = np.random.default_rng(0)
    n = 256
    g = CooGraph.from_edges(rng.integers(0, n, 2048), rng.integers(0, n, 2048),
                            nrows=n, ncols=n)
    prep = prepare_spmm(g, SpmmConfig(backend="ell", hidden_hint=8),
                        device=dev)
    x = torch.ones((n, 8), device=dev)
    t = device_time(prep.mul, x, iters=100)
    return max(0.0, t * 1e6 - RUN_OPS * launch_us)


# Readings of the stream copy, the row gather and K-core are each the
# fastest of this many timed runs (each after its own warm-up calls): one
# run can come out several times slower than the card (the smoke's tune
# phase once read the stream copy at about a quarter of its usual rate,
# which put K-core at 2.3 times its roofline), and no run can come out
# faster than the card.
BEST_OF = 5


def _best_times(fn, *args, iters: int, warmup: int = 2) -> "list[float]":
    """``device_time(fn, *args)`` over :data:`BEST_OF` runs (s each),
    fastest first."""
    from pygim_tpu_torch.utils.timers import device_time

    return sorted(device_time(fn, *args, iters=iters, warmup=warmup)
                  for _ in range(BEST_OF))


def _core_seconds(dev, gen) -> "list[float]":
    """K-core on one int8 band of :data:`CORE_BAND` rows and columns at H
    256: :func:`_best_times` (s)."""
    import torch

    from pygim_tpu_torch.ops.core_dot import core_bands_scatter_add, core_plans

    r = w = CORE_BAND
    band = torch.randint(-8, 8, (r, w), device=dev, generator=gen,
                         dtype=torch.int8)
    xc = torch.randn((w, 256), device=dev, generator=gen).to(torch.bfloat16)
    rows = torch.arange(r, dtype=torch.int32, device=dev)
    out = torch.zeros((r, 256), device=dev)
    stair = [(0, r, w)]
    plans = core_plans([band], stair, 256)
    return _best_times(lambda: core_bands_scatter_add(
        [band], xc, rows, stair, out, plans=plans), iters=10)


def measure_constants(device="cuda", save: bool = True, n: int = 1 << 21,
                      h: int = 256, g: int = 2_000_000) -> CardCostModel:
    """Measure the card's constants (module docstring) with CUDA events and
    cache them with the card's line (``save``). Raises without a card."""
    import torch

    from pygim_tpu_torch.utils.device import card_line, peaks

    dev = _card_device(device)
    card = card_line()
    name = torch.cuda.get_device_name(dev)
    hbm, bf16, _f32, _int8 = peaks(name)
    gen = torch.Generator(device=dev).manual_seed(0)
    readings: dict = {}

    x = torch.ones((n, h), device=dev)
    stream_t = _best_times(lambda: x * 1.0000001, iters=5)
    idx = torch.randint(0, n, (g,), device=dev, generator=gen)
    gather_t = _best_times(lambda: x.index_select(0, idx), iters=5)
    del x, idx
    stream_bw = 2 * n * h * 4 / stream_t[0]
    gather_bw = 2 * g * h * 4 / gather_t[0]
    readings.update(
        stream_GBps=stream_bw * 1e-9, gather_GBps=gather_bw * 1e-9,
        stream_GBps_runs=[2 * n * h * 4 / t * 1e-9 for t in stream_t],
        gather_GBps_runs=[2 * g * h * 4 / t * 1e-9 for t in gather_t])

    tail_ns = {(d, w): _tail_ns(dev, d, w, gen)
               for d in TAIL_DEGREES for w in TAIL_WIDTHS}
    fit = fit_tail(tail_ns)
    readings["tail_ns_per_vrow"] = {f"D{d} H{w}": v
                                    for (d, w), v in tail_ns.items()}
    readings["tail_fit"] = fit

    gather_eff, stream_eff = gather_bw / hbm, stream_bw / hbm
    launch_us = _launch_us(dev)
    fixed_us = _fixed_us(dev, launch_us)
    # K-rows on an R-MAT graph against the ELL issue time of its tables
    t_rows, rows_factor = _rows_factor(dev, fit)
    # K-core's share of its band's roofline (bytes at the stream rate,
    # operations at the bf16 rate)
    core_t = _core_seconds(dev, gen)
    t_core = core_t[0]
    roof = max(CORE_BAND * CORE_BAND / (hbm * stream_eff),
               2 * CORE_BAND * CORE_BAND * 256 / bf16)
    readings.update(launch_us=launch_us, fixed_us=fixed_us,
                    rows_ms=t_rows * 1e3, core_ms=t_core * 1e3,
                    core_ms_runs=[t * 1e3 for t in core_t],
                    core_roofline_ms=roof * 1e3)
    torch.cuda.empty_cache()

    model = CardCostModel(
        hbm_bw=hbm, ici_bw=NVLINK_BW, gather_eff=gather_eff,
        stream_eff=stream_eff, scatter_eff=stream_eff, fixed_us=fixed_us,
        tensor_bf16=bf16, tensor_f32=bf16 / 6,
        ell_slot_ns=fit["ell_slot_ns"],
        ell_vrow_fixed_ns=fit["ell_vrow_fixed_ns"],
        ell_vrow_ns_per_h=fit["ell_vrow_ns_per_h"], launch_us=launch_us,
        core_eff=roof / t_core, tail_roofline=False,
        rows_factor=rows_factor,
        provenance=f"measured:{card}",
    )
    if save:
        save_measured(model, card, readings)
    return model
