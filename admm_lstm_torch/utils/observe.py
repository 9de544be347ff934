"""Profiling and throughput observability.

Counterpart of `admm_lstm_tpu/utils/observe.py`: a `torch.profiler` trace
(CPU and, where a card is present, CUDA activity) around a code block,
written as a Chrome trace (viewable in Perfetto or chrome://tracing);
named regions that show up in it; and an iterations/s meter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from admm_lstm_torch.utils.logging import info


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Trace the block with torch.profiler and write the Chrome trace
    `trace_<pid>_<ms since the epoch>.json` into `log_dir`; a no-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f'trace_{os.getpid()}_'
                                 f'{int(time.time() * 1e3)}.json')
    prof.export_chrome_trace(path)
    info(f'Profiler trace written to {path}')


def annotate(name: str):
    """Named trace region (shows up in the profile)."""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Iterations/s over a sliding window; call update() once per step."""

    def __init__(self, window: int = 100) -> None:
        self.window = window
        self._times: list = []
        self.total = 0

    def update(self) -> None:
        self.total += 1
        now = time.perf_counter()
        self._times.append(now)
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def iters_per_s(self) -> float:
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0

    def report(self, prefix: str = '') -> None:
        info(f'{prefix}throughput: {self.iters_per_s:.1f} iters/s '
             f'({self.total} total)')
