"""The process-wide "raggesture" logger.  Port of ``get_root_logger`` of
``raggesture_tpu/utils/logger.py`` (its ``MetricWriter`` comes with the
training runtime)."""

from __future__ import annotations

import logging
import os
from typing import Optional

_LOGGER_NAME = "raggesture"
_LOG_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    """The "raggesture" logger: one stream handler, added at the first
    call, and a file handler per distinct ``log_file``."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not any(getattr(h, "_raggesture", False) for h in logger.handlers):
        logger.setLevel(log_level)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_LOG_FORMAT))
        sh._raggesture = True
        logger.addHandler(sh)
        logger.propagate = False
    if log_file is not None and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", None) == os.path.abspath(log_file)
        for h in logger.handlers
    ):
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(fh)
    return logger
