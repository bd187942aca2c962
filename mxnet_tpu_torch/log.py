"""Logging helpers (reference: python/mxnet/log.py — a colorized
formatter and ``get_logger``). Counterpart of ``mxnet_tpu/log.py``."""
import logging
import sys

__all__ = ["get_logger"]

_COLORS = {"WARNING": "\x1b[0;33m", "INFO": "\x1b[0;32m",
           "DEBUG": "\x1b[0;34m", "CRITICAL": "\x1b[0;35m",
           "ERROR": "\x1b[0;31m"}
_RESET = "\x1b[0m"


class _Formatter(logging.Formatter):
    """Level-colored formatter when the stream is a tty."""

    def __init__(self, colored):
        self._colored = colored
        super().__init__("%(asctime)s [%(levelname)s] %(message)s",
                         "%m%d %H:%M:%S")

    def format(self, record):
        out = super().format(record)
        if self._colored and record.levelname in _COLORS:
            return _COLORS[record.levelname] + out + _RESET
        return out


def get_logger(name=None, filename=None, filemode=None, level=logging.INFO):
    """A configured logger (reference: log.py:getLogger): colorized on
    ttys, plain into files."""
    logger = logging.getLogger(name)
    if getattr(logger, "_mxnet_init", False):
        return logger
    if filename:
        handler = logging.FileHandler(filename, filemode or "a")
        handler.setFormatter(_Formatter(colored=False))
    else:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(
            colored=hasattr(sys.stderr, "isatty") and sys.stderr.isatty()))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger._mxnet_init = True
    return logger
