"""Colored console logging mirrored to an auto-numbered file log.

Counterpart of `admm_lstm_tpu/utils/logging.py` (reference:
_global.py:117-200): `info`/`warning`/`error`/`log_assert` print colored
messages and append to ``logs/ADMMRunningLogs*.log``.  `error` raises
:class:`ADMMError` (the CLI converts it to an exit code).  File logging is
lazy and off when ADMM_TORCH_NO_FILELOG is set, which keeps tests and the
chip smoke run hermetic.  Also the reference's runtime helpers
(_global.py:68-106,157-227): `GlobalDict`, the `deprecated` and `callback`
decorators, and the host and device memory probes.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime
from typing import Any, Dict

RED = '\033[31m'
GREEN = '\033[32m'
YELLOW = '\033[33m'
RESET = '\033[0m'


class ADMMError(RuntimeError):
    """Raised by :func:`error`; carries an exit code for the CLI layer."""

    def __init__(self, msg: str, code: int = 1) -> None:
        super().__init__(msg)
        self.code = code


class GlobalDict:
    """Tiny cross-module key/value store (reference: _global.py:68-88)."""

    def __init__(self) -> None:
        self.contents: Dict[str, Any] = {}

    def set(self, key: str, value: Any) -> None:
        self.contents[key] = value

    def get(self, key: str) -> Any:
        return self.contents[key]

    def keys(self):
        return self.contents.keys()

    __setitem__ = set
    __getitem__ = get


global_dict = GlobalDict()

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
    global_dict['logger_filename'] = filename
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


def deprecated(msg: str = None):
    """Warn-on-call decorator (reference: _global.py:98-106)."""
    import functools

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warning(msg or f'{func.__name__} is deprecated and will be '
                           f'removed in future versions.')
            return func(*args, **kwargs)
        return wrapper
    return decorator


def callback(callback_func=None, *callback_args: Any):
    """Run `callback_func(*callback_args)` after each call of the wrapped
    function (reference: _global.py:157-165)."""
    import functools

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            results = func(*args, **kwargs)
            if callback_func is not None:
                callback_func(*callback_args)
            return results
        return wrapper
    return decorator


def current_memory_usage() -> int:
    """Resident host memory of this process in bytes (_global.py:220-223):
    psutil when available, /proc (Linux) otherwise."""
    try:
        import psutil
        return psutil.Process().memory_info().rss
    except ImportError:
        with open('/proc/self/statm') as f:
            return int(f.read().split()[1]) * os.sysconf('SC_PAGE_SIZE')


def total_memory() -> float:
    """Total host memory in GB (_global.py:226-227)."""
    try:
        import psutil
        return psutil.virtual_memory().total / 1024 ** 3
    except ImportError:
        with open('/proc/meminfo') as f:
            kb = int(f.readline().split()[1])
        return kb / 1024 ** 2


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats()` of the current card as a dict (bytes
    and counts of PyTorch's caching allocator); {} without a card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats())
