"""Dual-sink logger mirroring the reference's spdlog setup
(``src/Logging.cpp:13-49``): colored console at INFO and a
``superslam.log`` file at DEBUG/TRACE. Idempotent initialize()."""

from __future__ import annotations

import logging
import os
import threading

_lock = threading.Lock()
_initialized = False


def initialize(log_file: str | None = "superslam.log") -> logging.Logger:
    global _initialized
    with _lock:
        logger = logging.getLogger("superslam")
        if _initialized:
            return logger
        logger.setLevel(logging.DEBUG)
        logger.propagate = False

        console = logging.StreamHandler()
        console.setLevel(logging.INFO)
        console.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s", "%H:%M:%S")
        )
        logger.addHandler(console)

        if log_file and not os.environ.get("SUPERSLAM_NO_LOG_FILE"):
            try:
                fh = logging.FileHandler(log_file)
                fh.setLevel(logging.DEBUG)
                fh.setFormatter(
                    logging.Formatter(
                        "[%(asctime)s] [%(levelname)s] [%(threadName)s] %(message)s"
                    )
                )
                logger.addHandler(fh)
            except OSError:
                pass
        _initialized = True
        return logger


def get_logger() -> logging.Logger:
    return initialize()
