"""Leveled multi-sink logging with size-based rotation.

Replaces the reference's singleton Logger/FileLogger (src/common/logger.h:103-205)
with stdlib logging + RotatingFileHandler.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from typing import Optional

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_ROOT = "zlt"


def init_logging(level: str = "info", log_file: Optional[str] = None,
                 max_log_size_mb: int = 10, max_log_files: int = 5,
                 console: bool = True) -> logging.Logger:
    logger = logging.getLogger(_ROOT)
    logger.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    for h in logger.handlers:
        h.close()  # re-init must not leak the old file handler's fd
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d [%(levelname)s] %(name)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=max_log_size_mb * 1024 * 1024,
            backupCount=max_log_files)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
