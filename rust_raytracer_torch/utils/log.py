"""Structured logging for the framework (reference only prints to stdout:
main.rs:62-85, camera.rs:235-236, obj.rs:99).  The port's copy of
rust_raytracer_tpu/utils/log.py."""
from __future__ import annotations

import logging
import sys
import time

_logger = logging.getLogger("rust_raytracer_torch")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
    _logger.addHandler(handler)
    _logger.setLevel(logging.INFO)


def info(msg: str):
    _logger.info(msg)


def warning(msg: str):
    _logger.warning(msg)


class Timer:
    """Wall-clock scope timer (the reference's Instant prints)."""

    def __init__(self, label: str, quiet: bool = False):
        self.label = label
        self.quiet = quiet

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if not self.quiet:
            info(f"{self.label}: {self.elapsed:.2f}s")
