"""A results directory to CSV, the twin of
``pygim_tpu/bench/parse_results.py``: one row per ``.out`` record, its
parameters recovered from the frozen-name stem and its ``[DATA]`` keys
averaged over repeats, plus ``pim_time_dense(ms) = pim_time_spmm(ms) −
load_sparse_time(ms)`` where both are present. A directory holding a
record without a ``[DATA]device`` line (the TPU's ledger) is refused."""

from __future__ import annotations

import csv
import dataclasses
import re
from pathlib import Path

from pygim_tpu_torch.utils.metrics import mean_data, parse_data_lines


def _known_fields() -> list[str]:
    from pygim_tpu_torch.bench.experiment import Experiment

    return [f.name for f in dataclasses.fields(Experiment)]


def _params_from_name(stem: str) -> dict:
    """``{field: value}`` from an ``Experiment.frozen_name`` stem. Field
    names hold underscores (``block_nnz_budget``), so the stem is cut at
    the known field names (the longest first), each value running to the
    next ``_<field>-``; a stem with none is split into plain
    ``key-value`` tokens."""
    fields = sorted(_known_fields(), key=len, reverse=True)
    pat = re.compile(
        "(?:^|_)(" + "|".join(re.escape(f) for f in fields) + ")-"
    )
    hits = list(pat.finditer(stem))
    if not hits:
        out = {}
        for tok in stem.split("_"):
            if "-" in tok:
                k, v = tok.split("-", 1)
                out[k] = v
        return out
    out = {}
    for i, m in enumerate(hits):
        end = hits[i + 1].start() if i + 1 < len(hits) else len(stem)
        out[m.group(1)] = stem[m.end():end]
    return out


def results_to_csv(results_dir, out_csv=None) -> Path:
    """Write the rows to ``out_csv`` (default ``average_all.csv`` in the
    directory), columns sorted; an empty file where there is no record.
    Returns its path."""
    from pygim_tpu_torch.bench.experiment import refuse_foreign_records

    results_dir = Path(results_dir)
    refuse_foreign_records(results_dir)
    out_csv = Path(out_csv) if out_csv else results_dir / "average_all.csv"
    rows = []
    for f in sorted(results_dir.glob("*.out")):
        means = mean_data(parse_data_lines(f.read_text().splitlines()))
        if (
            "pim_time_spmm(ms)" in means
            and "load_sparse_time(ms)" in means
        ):
            means["pim_time_dense(ms)"] = (
                means["pim_time_spmm(ms)"] - means["load_sparse_time(ms)"]
            )
        rows.append({**_params_from_name(f.stem), **means})
    if not rows:
        out_csv.write_text("")
        return out_csv
    fields = sorted({k for r in rows for k in r})
    with out_csv.open("w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    return out_csv
