"""A profiler trace of whole jobs, reduced to what the per-layer metrics
read: each device operation (kernels, copies, fills) with its time, the
host's synchronizations, the union of the device's busy intervals and the
idle gaps between them, each named by what the host was doing then.

`torch.profiler` (CUPTI) times the device operations on the host's time
base, so the device's intervals and the host's operators line up.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, NamedTuple, Tuple

SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize')


class Trace(NamedTuple):
    device_ops: List[Tuple[str, float]]   # (name, seconds), in issue order
    syncs: int                            # host synchronizations
    busy_s: float                         # union of device intervals
    window_s: float                       # host clock over the traced jobs
    idle_gaps: Dict[str, float]           # idle seconds by host activity

    def kernels(self, patterns) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name holds one
        of `patterns`."""
        hits = [s for n, s in self.device_ops
                if any(p in n for p in patterns)]
        return sum(hits), len(hits)

    def top_ops(self, count: int = 10):
        total: Dict[str, float] = {}
        for name, s in self.device_ops:
            total[name[:120]] = total.get(name[:120], 0.0) + s
        return sorted(total.items(), key=lambda kv: -kv[1])[:count]

    def top_gaps(self, count: int = 10):
        return sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:count]


def profiled(fn):
    """Runs `fn` (work that ends in a synchronize) under torch.profiler:
    (its result, the raw profile for `read`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        window_s = time.perf_counter() - t0
    return out, (prof, window_s)


def _events(prof):
    """(start us, end us, name, on the device) of every event but user
    annotations: from the raw kineto events where this PyTorch has them
    (fast), else from `prof.events()`."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name(),
                 e.device_type() == cuda)
                for e in raw if not e.is_user_annotation()]
    except AttributeError:
        return [(e.time_range.start, e.time_range.end, e.name,
                 e.device_type == cuda) for e in prof.events()
                if not getattr(e, 'is_user_annotation', False)]


def read(raw) -> Trace:
    """The Trace of a raw profile from `profiled`."""
    prof, window_s = raw
    device, host = [], []
    syncs = 0
    for start, end, name, on_device in _events(prof):
        if on_device:
            device.append((start, end, name))
        else:
            syncs += name in SYNC_CALLS
            host.append((start, end, name))
    return summarize(device, host, syncs, window_s)


def _busy(device) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end, _ in sorted(device):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _activity(host, starts, at: float) -> str:
    """What the host was doing at time `at` (microseconds): the innermost
    PyTorch operator running then, else the innermost runtime call, else
    Python between operators."""
    runtime = None
    j = bisect.bisect_right(starts, at) - 1
    for k in range(j, max(j - 4000, -1), -1):
        start, end, name = host[k]
        if end >= at:
            if name.startswith('aten::'):
                return name
            runtime = runtime or name
    return runtime or 'python (no operator)'


def summarize(device, host, syncs, window_s) -> Trace:
    """`device` and `host`: (start us, end us, name) of each event."""
    ops = [(name, (end - start) * 1e-6)
           for start, end, name in sorted(device)]
    busy = _busy(device)
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        name = _activity(host, starts, 0.5 * (end + start))
        gaps[name] = gaps.get(name, 0.0) + (start - end) * 1e-6
    return Trace(ops, syncs, sum(b - a for a, b in busy) * 1e-6, window_s,
                 gaps)
