"""Colored console logging mirrored to an auto-numbered file log.

Counterpart of `admm_lstm_tpu/utils/logging.py` (reference:
_global.py:117-200): `info`/`warning`/`error`/`log_assert` print colored
messages and append to ``logs/ADMMRunningLogs*.log``.  `error` raises
:class:`ADMMError` (the CLI converts it to an exit code).  File logging is
lazy and off when ADMM_TORCH_NO_FILELOG is set, which keeps tests and the
chip smoke run hermetic.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime
from typing import Any

RED = '\033[31m'
GREEN = '\033[32m'
YELLOW = '\033[33m'
RESET = '\033[0m'


class ADMMError(RuntimeError):
    """Raised by :func:`error`; carries an exit code for the CLI layer."""

    def __init__(self, msg: str, code: int = 1) -> None:
        super().__init__(msg)
        self.code = code


_LOGGER: logging.Logger | None = None
_CONSOLE_ENABLED = True


def _now(fmt: str = '%H:%M:%S') -> str:
    return datetime.now().strftime(fmt)


def _file_logger() -> logging.Logger | None:
    """Create (once) a file logger under ./logs with an auto-numbered name."""
    global _LOGGER
    if os.environ.get('ADMM_TORCH_NO_FILELOG'):
        return None
    if _LOGGER is not None:
        return _LOGGER
    os.makedirs('logs', exist_ok=True)
    filename = 'logs/ADMMRunningLogs.log'
    if os.path.exists(filename):
        i = 1
        while os.path.exists(f'logs/ADMMRunningLogs_{i}.log'):
            i += 1
        filename = f'logs/ADMMRunningLogs_{i}.log'
    logger = logging.getLogger(f'admm_lstm_torch:{filename}')
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    handler = logging.FileHandler(filename)
    handler.setFormatter(logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s'))
    logger.addHandler(handler)
    _LOGGER = logger
    return logger


def set_console_enabled(enabled: bool) -> None:
    """Toggle console echo (file logging unaffected)."""
    global _CONSOLE_ENABLED
    _CONSOLE_ENABLED = bool(enabled)


def info(msg: Any = '', use_logger: bool = True) -> None:
    if use_logger and (logger := _file_logger()) is not None:
        logger.info(str(msg))
    if _CONSOLE_ENABLED:
        print(f'[{_now()}] {GREEN}INFO{RESET}: {msg}')


def warning(msg: Any = '', use_logger: bool = True) -> None:
    if use_logger and (logger := _file_logger()) is not None:
        logger.warning(str(msg))
    if _CONSOLE_ENABLED:
        print(f'[{_now()}] {YELLOW}WARNING{RESET}: {msg}')


def error(msg: Any = '', code: int = 1, use_logger: bool = True) -> None:
    if use_logger and (logger := _file_logger()) is not None:
        logger.error(str(msg))
    if _CONSOLE_ENABLED:
        print(f'[{_now()}] {RED}ERROR{RESET}: {msg}')
    raise ADMMError(str(msg), code)


def log_assert(condition: bool, msg: Any = '', code: int = 1) -> None:
    if not condition:
        error(msg, code)
