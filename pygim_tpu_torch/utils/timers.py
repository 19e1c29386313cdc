"""Phase timers and device timing.

Counterpart of ``pygim_tpu/utils/timers.py``. :class:`PhaseTimer`
accumulates named host phases. :func:`device_time` times a callable on
the device its output lives on: CUDA events on a card; the host clock
when the output lies on the CPU (the tests), where the CPU is the
device.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


class PhaseTimer:
    """Accumulating named host-phase timer: start/stop pairs, seconds per
    name in ``acc``."""

    def __init__(self):
        self.acc: dict[str, float] = {}
        self._t0: dict[str, float] = {}

    def start(self, name: str) -> None:
        self._t0[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        self.acc[name] = self.acc.get(name, 0.0) + (
            time.perf_counter() - self._t0.pop(name)
        )


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def device_time(fn: Callable, *args, iters: int = 8, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``, after ``warmup`` calls. On a
    CUDA output: one CUDA event pair around ``iters`` back-to-back calls,
    read after the end event completes. On a CPU output: the host clock."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
