"""Arithmetic that the metric files share.  Each metric file under
`end_to_end/` and `metrics/` keeps its own parameters (kernel names,
launch plans) and calls these.  `ctx` is the run's context (run.py):
`jobs` the window's unprofiled jobs, `traced_jobs` the profiled ones,
`trace` their Trace (trace.py) or None, and the cell's configuration,
traffic and sizes."""

from __future__ import annotations

import math

from portbench import flops, roofline


def rate(ctx, field):
    """Epochs or candidate-epochs of every job of the window over all of
    the window's time (jobs run back to back from its start)."""
    if not ctx.jobs:
        return None
    elapsed = ctx.jobs[-1].end - ctx.window_start
    return sum(getattr(j, field) for j in ctx.jobs) / elapsed


def percentile_ms(ctx, q):
    """The q-th percentile (nearest rank) of the jobs' wall times, ms."""
    times = sorted((j.end - j.start) * 1e3 for j in ctx.jobs)
    if not times:
        return None
    return times[max(0, math.ceil(q / 100.0 * len(times)) - 1)]


def traced(ctx, field):
    """Epochs or candidate-epochs of the profiled jobs."""
    if ctx.trace is None or not ctx.traced_jobs:
        return None
    return sum(getattr(j, field) for j in ctx.traced_jobs)


def per_traced(ctx, count, field):
    n = traced(ctx, field)
    return None if not n else count / n


def kernel_ms_per(ctx, patterns, field):
    """Device ms of the profiled kernels named by `patterns`, per epoch or
    candidate-epoch; None where no such kernel ran."""
    if ctx.trace is None:
        return None
    seconds, count = ctx.trace.kernels(patterns)
    return per_traced(ctx, seconds * 1e3, field) if count else None


def roofline_share(ctx, patterns, launches_per_epoch, bound_per_epoch):
    """100 x the least time of the kernels' work over their traced time.
    None unless they launched as the plan expects: `launches_per_epoch`
    launches in each (batched) epoch of the profiled jobs."""
    epochs = traced(ctx, 'epochs')
    if not epochs:
        return None
    seconds, count = ctx.trace.kernels(patterns)
    if count != launches_per_epoch * epochs or seconds <= 0:
        return None
    return 100.0 * bound_per_epoch * epochs / seconds


def idle_share(ctx):
    """100 x (1 - the device's busy seconds per epoch of the profiled jobs
    over the wall seconds per epoch of the window's unprofiled jobs).  The
    profiler slows the host, so the profiled jobs' own wall would read
    the idle share high on a host-bound cell."""
    busy = per_traced(ctx, ctx.trace.busy_s, 'epochs') if ctx.trace else None
    epochs = sum(j.epochs for j in ctx.jobs)
    wall = sum(j.end - j.start for j in ctx.jobs)
    if busy is None or not epochs or wall <= 0:
        return None
    return 100.0 * (1.0 - busy * epochs / wall)


def mfu(ctx):
    """100 x the operations the window's unprofiled jobs needed (flops.py)
    per second of their wall time, over the configuration's peak."""
    seconds = sum(j.end - j.start for j in ctx.jobs)
    if not seconds:
        return None
    ops = flops.epoch_ops(ctx.sizes,
                          ctx.config['reference_rules'].get('exact_max_dim',
                                                            0))
    done = sum(j.cand_epochs for j in ctx.jobs)
    return (100.0 * ops * done / seconds
            / roofline.PEAK_FLOPS[ctx.config['peak']])
