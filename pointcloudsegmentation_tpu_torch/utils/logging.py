"""Logging: stdout + optional flat log file (the reference's ``log_str``,
train_util.py:70-74); the port's own copy of
``pointcloudsegmentation_tpu.utils.logging``, under the ``pcs_torch``
logger tree."""
from __future__ import annotations

import logging
import sys
from typing import Optional

_CONFIGURED = False


def get_logger(name: str = "pcs_torch",
               log_file: Optional[str] = None) -> logging.Logger:
    global _CONFIGURED
    if not name.startswith("pcs_torch"):
        name = "pcs_torch." + name.rsplit(".", 1)[-1]
    logger = logging.getLogger(name)
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root = logging.getLogger("pcs_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(fh)
    return logger
