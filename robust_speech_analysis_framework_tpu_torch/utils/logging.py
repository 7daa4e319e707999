"""Structured logging (counterpart of the JAX package's ``utils/logging.py``)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "rsaf", level: Optional[str] = None) -> logging.Logger:
    """A logger writing to stderr at ``level``, else ``RSAF_LOG_LEVEL``, else
    INFO; its handler is added once."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(level or os.environ.get("RSAF_LOG_LEVEL", "INFO"))
    return logger
