"""Profiling: a `torch.profiler` trace of a block and the program's
named spans.

Counterpart of `admm_lstm_tpu/utils/observe.py`: `profile_trace` writes a
`torch.profiler` trace (CPU and, where a card is present, CUDA activity)
of a code block as a Chrome trace (viewable in Perfetto or
chrome://tracing).  `span(name)` marks a phase of the program (the epoch,
its weight stages, its sweep, the line searches' host reads); the spans
exist only while a profiler records.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from admm_lstm_torch.utils.logging import info

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the program: `torch.profiler.record_function(name)`
    while a `torch.profiler` session records, so it lands in the same trace
    as the operators and device work it encloses (on their clock, nested
    in the span around it); otherwise one shared no-op context, which costs
    a flag read."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Trace the block with torch.profiler and write the Chrome trace
    `trace_<pid>_<ms since the epoch>.json` into `log_dir`; a no-op when
    log_dir is None.  The program's spans (`span`) show in it as user
    annotations around the operators they enclose."""
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
