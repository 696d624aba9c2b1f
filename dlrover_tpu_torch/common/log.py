"""Structured logging (reference: dlrover/python/common/log.py)."""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(name)s:%(lineno)d] %(message)s"
)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("DLROVER_TPU_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger


default_logger = get_logger("dlrover_tpu_torch")
