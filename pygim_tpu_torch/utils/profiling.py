"""Profiling hooks on ``torch.profiler``, the twin of
``pygim_tpu/utils/profiling.py``: :func:`trace` writes a chrome trace
(Perfetto, ``chrome://tracing``) of the host and, where there is a card,
of its kernels; :func:`annotate` names a region in it, and on the card
also in NVTX."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

TRACE_ENV = "PYGIM_TPU_TRACE_DIR"


def trace_dir(logdir: str | None = None) -> str:
    """``logdir``, else ``$PYGIM_TPU_TRACE_DIR``, else ``pygim_trace`` in
    the temporary directory."""
    return logdir or os.environ.get(TRACE_ENV) or os.path.join(
        tempfile.gettempdir(), "pygim_trace")


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the body and write its chrome trace to
    ``<logdir>/trace-<pid>-<ns>.json`` when it ends, also when it raises.
    Yields the directory. Where the profiler cannot start (another
    profiler is active), the body runs untraced."""
    logdir = trace_dir(logdir)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        prof.__enter__()
        started = True
    except RuntimeError:
        started = False
    try:
        yield logdir
    finally:
        if started:
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region: ``record_function`` in the profiler's trace and,
    on the card, an NVTX range. An exception in the body propagates
    unchanged."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
