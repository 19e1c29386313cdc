"""Experiment points, the frozen-name ledger and the sweep runner: the
twin of ``pygim_tpu/bench/experiment.py``.

* ``Experiment`` has the reference's fields, defaults and order, and its
  ``frozen_name``, ``matches_legacy_stem`` and ``status_at`` unchanged,
  so one point has the same stem in both packages.
* A run writes ``<stem>.out`` (its ``[DATA]`` record), ``<stem>.json``
  (the means), or on any failure ``<stem>.failed`` (the record so far and
  the traceback) before it raises.
* Every record holds one ``[DATA]device`` line: the card's name and power
  limit as ``nvidia-smi`` gives them, or ``cpu``. The TPU's records under
  ``results/`` have the same stems and no such line, so
  :func:`run_experiments` (and ``results_to_csv``) refuse a directory
  that holds an ``.out`` without one: a TPU record is never skipped as
  done here, nor read as the port's number. ``run_experiments`` also
  refuses a record of another device (the CPU, another card or power
  limit): a sweep never skips a point that another device ran.
* ``tune=True`` runs the autotuner (``tune/autotuner.py:autotune``, mode
  ``model``, the card's cost model) on the loaded graph and runs its pick,
  recording ``tuned_backend``, ``tuned_balance`` and
  ``tuned_block_nnz_budget``. As in the reference, the pick replaces the
  whole config, ``sp_format`` included.
* ``sp_parts · ds_parts > 1`` runs the spmm, inference and training
  kinds over a 2D mesh (``parallel/spmm_2d.py``; training through its
  prepared transpose): on the card over the visible cards (one card
  raises ``ValueError``, as the reference on one chip), on
  ``device="cpu"`` over ``sp · ds`` copies of the CPU device.
* ``kind="scaling"`` runs ``bench/scaling.py:run_scaling_benchmark`` with
  ``exchange``, ``cluster`` (the node order), ``device_counts`` and
  ``scale_model``: on the card over the visible cards, on
  ``device="cpu"`` over as many copies of the CPU device as the largest
  count (a virtual mesh, ``virtual_mesh`` true).
* ``part_method="metis"`` takes a part of the multilevel k-way partition
  (``data/datasets.py:cluster_partition``).
"""

from __future__ import annotations

import dataclasses
import gc
import io
import json
import logging
import resource
import time
import traceback
from pathlib import Path
from typing import Iterable, Optional

import torch

from pygim_tpu_torch.ops.spmm import SpmmConfig
from pygim_tpu_torch.utils.metrics import DataReporter, parse_data_lines


@dataclasses.dataclass(frozen=True)
class Experiment:
    """One run point, the reference's ``Experiment`` field for field."""

    dataset: str = "pubmed"
    kind: str = "spmm"            # spmm | inference | scaling | training
    model: str = "gcn"
    num_layers: int = 2
    hidden: int = 256
    sp_parts: int = 1
    ds_parts: int = 1
    sp_format: str = "csr"
    dtype: str = "float32"        # spmm payload / aggregation dtype
    backend: str = "blocked"
    balance: str = "nnz"
    block_nnz_budget: int = 1 << 17
    ell_degree: int = 0                # 0 = auto
    ell_tables: int = 3                # max multi-degree ELL tables
    hybrid_core_bytes: int = 4 << 30   # hybrid backend core budget
    hybrid_dtype: str = ""             # "" = the graph's dtype
    hybrid_shape: str = "square"       # square | stair
    stair_max_bands: int = 8           # stair: band budget
    bcsr_bytes: int = 0                # hybrid BCSR middle-tier budget
    bcsr_tile: int = 32
    bcsr_order: str = "rank"           # rank | rcm | lp
    bcsr_layout: str = "row"           # row | panel
    exchange: str = "all_to_all"       # scaling kind: halo exchange
    cluster: str = ""                  # scaling kind: node order
    device_counts: str = ""            # scaling kind: comma list
    scale_model: bool = False          # scaling kind: the model forward
    phases: bool = False               # spmm kind: per-phase [DATA] times
    validate: bool = False             # inference kind: per-layer check
    epochs: int = 50                   # training kind
    lr: float = 0.01                   # training kind
    parity: bool = True                # training kind: against the oracle
    oracle_chunk: int = 0              # training kind: oracle edge chunk
    part_size: int = 0                 # >0: one cluster partition
    part_idx: int = 1                  # which partition
    part_method: str = "none"          # none | rcm | lp | metis
    repeat: int = 3
    tune: bool = False
    data_tag: str = ""                 # free-form provenance tag

    def frozen_name(self) -> str:
        """The result file's stem: ``key-value`` of every field in sorted
        order, where fields at their default are left out (``dataset``,
        ``kind`` and ``backend`` always stay)."""
        d = dataclasses.asdict(self)
        keep = {"dataset", "kind", "backend"}
        defaults = {
            f.name: f.default for f in dataclasses.fields(Experiment)
        }
        return "_".join(
            f"{k}-{d[k]}"
            for k in sorted(d)
            if k in keep or d[k] != defaults[k]
        )

    def spmm_config(self) -> SpmmConfig:
        return SpmmConfig(
            format=self.sp_format, backend=self.backend,
            balance=self.balance, block_nnz_budget=self.block_nnz_budget,
            ell_degree=self.ell_degree or None,
            ell_tables=self.ell_tables,
            hybrid_core_bytes=self.hybrid_core_bytes,
            hybrid_dtype=self.hybrid_dtype or None,
            hybrid_shape=self.hybrid_shape,
            stair_max_bands=self.stair_max_bands,
            bcsr_bytes=self.bcsr_bytes, bcsr_tile=self.bcsr_tile,
            bcsr_order=self.bcsr_order, bcsr_layout=self.bcsr_layout,
            hidden_hint=self.hidden,
        )

    def matches_legacy_stem(self, stem: str) -> bool:
        """Whether ``stem`` is a name this point had under an older field
        set, written before defaults were left out: every field then in
        sorted order, so each token present must match this point's value
        and a field missing from it must sit at its default here."""
        d = dataclasses.asdict(self)
        defaults = {
            f.name: f.default for f in dataclasses.fields(Experiment)
        }
        rest = stem
        for k in sorted(d):
            tok = f"{k}-{d[k]}"
            if rest == tok:
                rest = ""
            elif rest.startswith(tok + "_"):
                rest = rest[len(tok) + 1:]
            elif d[k] != defaults[k]:
                return False
        return rest == ""

    def status_at(self, results_dir) -> str:
        """done | failed | todo: the current stem first, then any legacy
        stem in the directory."""
        stem = Path(results_dir) / self.frozen_name()
        if stem.with_suffix(".out").exists():
            return "done"
        if stem.with_suffix(".failed").exists():
            return "failed"
        rd = Path(results_dir)
        if rd.is_dir():
            for p in rd.iterdir():
                if p.suffix in (".out", ".failed") and \
                        self.matches_legacy_stem(p.stem):
                    return "done" if p.suffix == ".out" else "failed"
        return "todo"

    def refusal(self) -> Optional[str]:
        """Why the port cannot run this point, or None: every field
        setting of the reference's runs. ``tune=True`` tunes for one
        card, as the reference's (``autotune(graph, hidden)``); the
        tuner's multi-card plans are reached through ``autotune(...,
        n_devices=)`` and the entry scripts' ``--tune``."""
        return None

    def run(self, results_dir, data_root: Optional[str] = None,
            device="cuda") -> dict:
        """Run in this process on ``device``; write the ``[DATA]`` record
        and the JSON means to the ledger. On any failure the ``.failed``
        file is written first, then the error is raised. A hybrid
        operand's shape goes into the record too (``core_bands``,
        ``core_dtype``, ``core_coverage``, ``tail_edges``,
        ``merged_edges``, and with a BCSR tier ``bcsr_kind``,
        ``bcsr_tiles``, ``bcsr_edges``, ``bcsr_coverage``), and so do the dataset's load time (a synthesis
        where its cache is cold: ``load_dataset_time(ms)``), its
        ``stored_edges``, the process's peak host memory so far
        (``peak_host_rss_bytes``) and on the card the run's peak device
        memory (``peak_card_bytes``)."""
        from pygim_tpu_torch.bench.runners import (
            run_inference_benchmark,
            run_spmm_benchmark,
            run_training_benchmark,
        )
        from pygim_tpu_torch.data import cluster_partition, load_dataset
        from pygim_tpu_torch.ops.spmm import prepare_spmm

        results_dir = Path(results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)
        stem = results_dir / self.frozen_name()
        dev = torch.device(device)
        card = device_line(dev)
        rep = DataReporter(echo=False)
        prepared = []

        mesh = None

        def prepare(graph, config):
            if mesh is not None:
                from pygim_tpu_torch.parallel import prepare_spmm_2d

                prep = prepare_spmm_2d(graph, mesh, config)
            else:
                prep = prepare_spmm(graph, config, device=dev)
            prepared.append(prep)
            return prep

        try:
            n_mesh = self.sp_parts * self.ds_parts
            if n_mesh > 1:
                from pygim_tpu_torch.parallel import make_mesh

                mesh = make_mesh(self.sp_parts, self.ds_parts,
                                 None if dev.type == "cuda" else [dev] * n_mesh)
            cfg = self.spmm_config()
            cfg.check_supported()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            ds = load_dataset(self.dataset, root=data_root)
            rep.report("load_dataset_time(ms)",
                       (time.perf_counter() - t0) * 1e3)
            rep.report("stored_edges", ds.graph.nnz)
            if self.part_size > 0:
                ds = cluster_partition(
                    ds, part_size=self.part_size,
                    part_idx=self.part_idx, method=self.part_method,
                )
                rep.report("part_nodes", ds.num_nodes)
                rep.report("part_edges", ds.graph.nnz)
            if self.tune:
                from pygim_tpu_torch.tune import autotune

                cfg = autotune(ds.graph, self.hidden, device=dev).config
                # the frozen name carries the config before tuning: the
                # pick is recorded here
                rep.report("tuned_backend", cfg.backend)
                rep.report("tuned_balance", cfg.balance)
                rep.report("tuned_block_nnz_budget", cfg.block_nnz_budget)
            agg_dtype = None if self.dtype == "float32" else self.dtype
            if self.kind == "spmm":
                run_spmm_benchmark(
                    ds, hidden=self.hidden, dtype=self.dtype, config=cfg,
                    repeat=self.repeat, reporter=rep, prepare_fn=prepare,
                    phases=self.phases, device=dev,
                )
            elif self.kind == "inference":
                run_inference_benchmark(
                    ds, model=self.model, num_layers=self.num_layers,
                    hidden=self.hidden, agg_dtype=agg_dtype, config=cfg,
                    repeat=self.repeat, reporter=rep, prepare_fn=prepare,
                    validate=self.validate, device=dev,
                )
            elif self.kind == "scaling":
                from pygim_tpu_torch.bench.scaling import (
                    run_scaling_benchmark,
                )

                counts = ([int(c) for c in self.device_counts.split(",")]
                          if self.device_counts else None)
                run_scaling_benchmark(
                    ds, device_counts=counts, hidden=self.hidden,
                    exchange=self.exchange, config=cfg, repeat=self.repeat,
                    reporter=rep,
                    model=self.model if self.scale_model else None,
                    num_layers=self.num_layers, agg_dtype=agg_dtype,
                    order=self.cluster or None,
                    devices=(None if dev.type == "cuda"
                             else [dev] * max(counts or [1])))
            elif self.kind == "training":
                run_training_benchmark(
                    ds, model=self.model, num_layers=self.num_layers,
                    hidden=self.hidden, config=cfg, epochs=self.epochs,
                    lr=self.lr, reporter=rep, prepare_fn=prepare,
                    parity=self.parity,
                    oracle_chunk=self.oracle_chunk or None, device=dev,
                )
            else:
                raise ValueError(f"unknown kind {self.kind!r}")
            if prepared and cfg.backend == "hybrid" and mesh is None:
                _report_operand(prepared[0], self.hidden, rep)
            # ru_maxrss is in KiB on Linux
            rep.report("peak_host_rss_bytes", resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024)
            if dev.type == "cuda":
                rep.report("peak_card_bytes",
                           torch.cuda.max_memory_allocated(dev))
        except Exception:
            stem.with_suffix(".failed").write_text(
                _render_record(self, rep, card) + "\n"
                + traceback.format_exc()
            )
            raise
        finally:
            prepared.clear()
        means = {**rep.means(), "device": card}
        stem.with_suffix(".out").write_text(_render_record(self, rep, card))
        stem.with_suffix(".json").write_text(json.dumps(means, indent=1))
        return means


def device_line(dev: torch.device) -> str:
    """The ``[DATA]device`` value: on the card, its name and power limit
    (``nvidia-smi``); elsewhere the device type."""
    if dev.type != "cuda":
        return dev.type
    from pygim_tpu_torch.utils.device import card_line

    return card_line()


def _report_operand(prep, hidden: int, rep: DataReporter) -> None:
    from pygim_tpu_torch.bench.report import operand_info

    # the shape alone: with a CPU device operand_info skips the card's
    # schedules and bounds
    info = operand_info(prep, hidden, torch.device("cpu"))
    rep.report("core_bands", json.dumps(info["bands"]))
    rep.report("core_dtype", info["core_dtype"])
    rep.report("core_coverage", info["core_coverage"])
    rep.report("tail_edges", info["tail_edges"])
    rep.report("merged_edges", int(prep.nnz))
    if prep.has_bcsr:
        for k in ("bcsr_kind", "bcsr_edges", "bcsr_coverage"):
            rep.report(k, info[k])
        rep.report("bcsr_tiles", json.dumps(info["bcsr_tiles"]))


def _render_record(exp: Experiment, rep: DataReporter, card: str) -> str:
    """The record: its one ``[DATA]device`` line, ``card``, in place of
    the runners' bare device name, then the runners' lines."""
    buf = io.StringIO()
    print(f"# {exp.frozen_name()}", file=buf)
    print(f"[DATA]device: {card}", file=buf)
    for k, vs in rep.records.items():
        if k == "device":
            continue
        for v in vs:
            print(f"[DATA]{k}: {v}", file=buf)
    return buf.getvalue()


def refuse_foreign_records(results_dir, card: Optional[str] = None) -> None:
    """Raise ``ValueError`` naming the first ``.out`` in ``results_dir``
    that has no ``[DATA]device`` line (a record this package did not
    write: the TPU's ledger under ``results/`` has the same stems) or,
    where ``card`` is given, whose device line is not ``card``."""
    rd = Path(results_dir)
    if not rd.is_dir():
        return
    for p in sorted(rd.glob("*.out")):
        got = parse_data_lines(p.read_text().splitlines()).get("device")
        if got is None:
            raise ValueError(
                f"{p}: a record without a [DATA]device line, not one of this "
                "port's (results/ is the TPU ledger); use another results "
                "directory")
        if card is not None and got != [card]:
            raise ValueError(
                f"{p}: a record of {got[-1]!r}, not of this sweep's device "
                f"{card!r}; use another results directory")


def run_experiments(
    experiments: Iterable[Experiment],
    results_dir,
    *,
    retry_failed: bool = False,
    dry_run: bool = False,
    logger: Optional[logging.Logger] = None,
    data_root: Optional[str] = None,
    device="cuda",
) -> dict[str, dict]:
    """The sweep: skip points that are done (returning their recorded
    means) or failed (unless ``retry_failed``), run the rest on
    ``device`` and collect their means by frozen name. A failure is
    logged and does not stop the sweep. ``dry_run`` runs nothing. Raises
    ``ValueError`` on a directory holding another package's records or
    another device's (a dry run without the card checks the former only),
    and ``RuntimeError`` where ``device`` is the card and there is none."""
    log = logger or logging.getLogger("pygim_tpu_torch.bench")
    dev = torch.device(device)
    present = dev.type != "cuda" or torch.cuda.is_available()
    if not dry_run and not present:
        raise RuntimeError(f"run_experiments: device {device!r} but no CUDA "
                           "card")
    refuse_foreign_records(results_dir, device_line(dev) if present else None)
    results = {}
    for exp in experiments:
        name = exp.frozen_name()
        status = exp.status_at(results_dir)
        if status == "done" or (status == "failed" and not retry_failed):
            log.info("skip [%s] %s", status, name)
            if status == "done":
                p = Path(results_dir) / (name + ".json")
                if p.exists():
                    results[name] = json.loads(p.read_text())
            continue
        if dry_run:
            log.info("dry-run %s", name)
            continue
        log.info("run %s", name)
        try:
            results[name] = exp.run(results_dir, data_root=data_root,
                                    device=device)
        except Exception as e:  # noqa: BLE001 — the ledger has the .failed
            log.error("FAILED %s: %s", name, e)
            # free the failed run's device memory before the next point:
            # its tensors stay alive in the traceback's frames otherwise
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return results
