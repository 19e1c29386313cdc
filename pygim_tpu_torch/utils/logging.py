"""Logging helper: ``make_logger``, the twin of
``pygim_tpu/utils/logging.py``: a stdout handler and an optional file
handler, each added once per logger name, so calling it again with the
same name and file adds nothing."""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)s %(message)s"


def make_logger(
    name: str = "pygim_tpu_torch", logfile: Optional[str] = None,
    level: int = logging.INFO,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not any(
        isinstance(h, logging.StreamHandler) and h.stream is sys.stdout
        for h in logger.handlers
    ):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
    if logfile is not None:
        logfile = str(Path(logfile))
        if not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == logfile
            for h in logger.handlers
        ):
            fh = logging.FileHandler(logfile)
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger
