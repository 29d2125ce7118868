"""Colored singleton logger (the port's copy of JAX ``utils/log.py``), for
the classes that take a ``log_level``."""

import logging
import os

_LOG_FORMAT = "[%(asctime)s] %(levelname)s: %(message)s"
_DATE_FORMAT = "%H:%M:%S"

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if os.environ.get("NO_COLOR"):
            return msg
        color = _COLORS.get(record.levelname)
        return f"{color}{msg}{_RESET}" if color else msg


def get_logger(name: str = "gnn_tracking_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    """Return a configured singleton logger."""
    log = logging.getLogger(name)
    if log.handlers:
        return log
    log.setLevel(level)
    handler = logging.StreamHandler()
    handler.setFormatter(_ColorFormatter(_LOG_FORMAT, _DATE_FORMAT))
    log.addHandler(handler)
    log.propagate = False
    return log
