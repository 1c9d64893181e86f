"""Leveled logging (port of ``raytracer_tpu/utils/logger.py``).

Python's stdlib logging with four levels (debug, info, warning, error) and
a compact one-line format on stderr; ``RT_LOG_LEVEL`` sets the first level.
In a ``torch.distributed`` run of more than one rank, each line carries the
rank, read when the logger is first used.  The logger never initialises a
process group itself.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "raytracer_tpu_torch"
_configured = False


def _rank_prefix() -> str:
    """``"[rank r] "`` inside an initialised process group of more than one
    rank, else ``""``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return f"[rank {dist.get_rank()}] "
    return ""


def _configure() -> logging.Logger:
    global _configured
    logger = logging.getLogger(_LOGGER_NAME)
    if _configured:
        return logger
    _configured = True
    level_name = os.environ.get("RT_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level_name, logging.INFO))
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(f"%(asctime)s {_rank_prefix()}%(levelname).1s %(message)s", datefmt="%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def log_debug(fmt: str, *args) -> None:
    _configure().debug(fmt, *args)


def log_info(fmt: str, *args) -> None:
    _configure().info(fmt, *args)


def log_warning(fmt: str, *args) -> None:
    _configure().warning(fmt, *args)


def log_error(fmt: str, *args) -> None:
    _configure().error(fmt, *args)


def set_level(level: str) -> None:
    _configure().setLevel(getattr(logging, level.upper()))
