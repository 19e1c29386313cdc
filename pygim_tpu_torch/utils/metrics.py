"""The ``[DATA]key: value`` stdout protocol — line for line the format of
``pygim_tpu/utils/metrics.py``, so one parser reads both packages."""

from __future__ import annotations

import re
import sys
from collections import defaultdict
from typing import Iterable, TextIO

_DATA_RE = re.compile(r"^\[DATA\]\s*([^:]+?)\s*:\s*(.+?)\s*$")


def data_print(key: str, value, stream: TextIO | None = None) -> None:
    """Emit one metric line, e.g. ``[DATA]pim_time_spmm(ms): 12.3``."""
    print(f"[DATA]{key}: {value}", file=stream or sys.stdout, flush=True)


def parse_data_lines(lines: Iterable[str]) -> dict[str, list]:
    """Collect repeated ``[DATA]`` keys; values parsed as float when
    possible, else kept as strings."""
    out: dict[str, list] = defaultdict(list)
    for line in lines:
        m = _DATA_RE.match(line.strip())
        if not m:
            continue
        key, raw = m.group(1), m.group(2)
        try:
            out[key].append(float(raw))
        except ValueError:
            out[key].append(raw)
    return dict(out)


def mean_data(parsed: dict[str, list]) -> dict[str, float]:
    """Mean over repeats for numeric keys."""
    res = {}
    for k, vs in parsed.items():
        nums = [v for v in vs if isinstance(v, float)]
        if nums:
            res[k] = sum(nums) / len(nums)
    return res


class DataReporter:
    """Buffers metrics and emits them as ``[DATA]`` lines."""

    def __init__(self, echo: bool = True):
        self.echo = echo
        self.records: dict[str, list] = defaultdict(list)

    def report(self, key: str, value) -> None:
        self.records[key].append(value)
        if self.echo:
            data_print(key, value)

    def means(self) -> dict:
        """Numeric keys averaged over repeats; string keys pass through as
        their last value."""
        res = mean_data(dict(self.records))
        for k, vs in self.records.items():
            if k not in res and vs:
                res[k] = vs[-1]
        return res
