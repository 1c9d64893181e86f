"""Utility layer: logging, and the spans and counters of ``profiler``
(port of ``raytracer_tpu/utils``)."""

from .logger import log_debug, log_error, log_info, log_warning, set_level
from .profiler import (
    collect,
    count,
    enable,
    host_sync,
    report,
    reset,
    scoped_timer,
    span,
)

__all__ = [
    "log_debug", "log_info", "log_warning", "log_error", "set_level",
    "span", "host_sync", "count", "enable", "scoped_timer", "collect", "report", "reset",
]
