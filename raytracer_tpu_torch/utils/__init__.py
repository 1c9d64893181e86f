"""Utility layer: logging, profiling (port of ``raytracer_tpu/utils``)."""

from .logger import log_debug, log_error, log_info, log_warning, set_level
from .profiler import (
    collect,
    device_trace,
    profiled,
    report,
    reset,
    scoped_timer,
)

__all__ = [
    "log_debug", "log_info", "log_warning", "log_error", "set_level",
    "scoped_timer", "device_trace", "profiled", "collect", "report", "reset",
]
