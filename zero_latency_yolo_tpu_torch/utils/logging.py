"""Named loggers under the "zlt" root (the part of the JAX package's
`utils/logging.py` the engine uses)."""

from __future__ import annotations

import logging

_ROOT = "zlt"


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
