"""Logging setup (port of ``msa_tpu/utils/logging_config.py``): the root
logger with a timestamped file ``logs/analysis_YYYYmmdd_HHMMSS.log`` and a
console handler, and the chatty dependencies kept at WARNING."""

from __future__ import annotations

import logging
import os
from datetime import datetime
from pathlib import Path


def setup_logging(
    log_dir: str = "logs",
    level: int | str | None = None,
    console: bool = True,
) -> str:
    """Configure root logging (its handlers are replaced); returns the
    log-file path. ``LOG_LEVEL`` and ``LOG_FORMAT`` override the defaults."""
    level = level if level is not None else os.getenv("LOG_LEVEL", "INFO")
    fmt = os.getenv("LOG_FORMAT", "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    log_file = str(Path(log_dir) / f"analysis_{datetime.now().strftime('%Y%m%d_%H%M%S')}.log")

    root = logging.getLogger()
    root.setLevel(level)
    root.handlers.clear()
    formatter = logging.Formatter(fmt)
    fh = logging.FileHandler(log_file)
    fh.setFormatter(formatter)
    root.addHandler(fh)
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(formatter)
        root.addHandler(ch)

    for noisy in ("torch", "matplotlib", "PIL"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
    return log_file
