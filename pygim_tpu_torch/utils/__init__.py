"""Shared utilities: the [DATA] metric protocol, phase timers, the card's
peaks, the caches, logging and profiling."""

from pygim_tpu_torch.utils.metrics import DataReporter, data_print, parse_data_lines
from pygim_tpu_torch.utils.timers import PhaseTimer, device_time

__all__ = ["DataReporter", "PhaseTimer", "data_print", "device_time",
           "parse_data_lines"]
