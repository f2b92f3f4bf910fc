"""Logging helpers (counterpart of `radvlm_tpu/utils/logging_utils.py`,
rebuild of `finetuning/llava/utils.py:73-160`).

`setup_logging` = build_logger: console + rotating file handler, one file per
process; `process_zero_log` = rank0_print. The process index is
`torch.distributed.get_rank()` when a process group is initialised; without
one the file name has no suffix and the process is rank 0.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional


def _rank() -> Optional[int]:
    """The process group's rank, or None when there is no group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return None


def setup_logging(
    name: str = "radvlm_tpu",
    *,
    level: int = logging.INFO,
    log_dir: Optional[str] = None,
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s | %(levelname)s | %(name)s | %(message)s"
        )
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            rank = _rank()
            suffix = "" if rank is None else f"_p{rank}"
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"{name}{suffix}.log"),
                maxBytes=50 * 1024 * 1024,
                backupCount=3,
            )
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def process_zero_log(logger: logging.Logger, msg: str, *args) -> None:
    """Log only on process 0 (the reference's rank0_print)."""
    if (_rank() or 0) != 0:
        return
    logger.info(msg, *args)
