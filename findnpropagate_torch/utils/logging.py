"""File + console logger — port of findnpropagate_tpu/utils/logging.py
(the reference's common_utils.create_logger)."""

from __future__ import annotations

import logging


def create_logger(log_file=None, rank: int = 0, log_level=logging.INFO):
    logger = logging.getLogger("findnpropagate_torch")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    console = logging.StreamHandler()
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(filename=str(log_file))
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
