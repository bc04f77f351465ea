"""Small host utilities (port of ``msa_tpu/utils/misc.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

DEFAULT_DIRECTORIES = ("data", "checkpoints", "output", "temp", "logs")


def create_directories(paths: Iterable[str] = DEFAULT_DIRECTORIES) -> None:
    """Create the CLI's working directories under the working directory."""
    for p in paths:
        Path(p).mkdir(parents=True, exist_ok=True)
