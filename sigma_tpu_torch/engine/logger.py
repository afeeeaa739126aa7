"""Jax-free logger: the counterpart of `sigma_tpu/engine/logger.py`
(importing that module runs `sigma_tpu/engine/__init__.py`, which imports
jax). Same format and the same ENGINE_LOGGING_LEVEL env var. In
data-parallel training rank 0 logs; the other ranks log only warnings
and errors."""

from __future__ import annotations

import logging
import os
import sys

from sigma_tpu_torch.parallel.dist import is_main

_COLORS = {"WARNING": 33, "INFO": 36, "DEBUG": 37, "CRITICAL": 35, "ERROR": 31}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        level = record.levelname
        if sys.stderr.isatty() and level in _COLORS:
            record.levelname = f"\x1b[{_COLORS[level]}m{level}\x1b[0m"
        out = super().format(record)
        record.levelname = level
        return out


def get_logger() -> logging.Logger:
    """The package logger, configured once (stderr handler, level from
    ENGINE_LOGGING_LEVEL, default INFO)."""
    logger = logging.getLogger("sigma_tpu_torch")
    if not logger.handlers:
        level = os.environ.get("ENGINE_LOGGING_LEVEL", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _ColorFormatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
        )
        handler.addFilter(
            lambda record: record.levelno >= logging.WARNING or is_main())
        logger.addHandler(handler)
        logger.propagate = False
    return logger
