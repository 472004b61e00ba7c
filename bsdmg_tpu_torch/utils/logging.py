"""Structured logging (the reference logs stage transitions and voxel,
vertex and triangle counts with Bevy's ``info!``, src/cuda/mod.rs:132-135,
197-201, 301). Port of ``bsdmg_tpu/utils/logging.py``."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "bsdmg") -> logging.Logger:
    """The logger ``name``, given a stderr handler and level INFO the first
    time (a logger that has a handler is returned as it is)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
