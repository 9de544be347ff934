"""The program's spans in a profiled block of a cell's jobs: host
synchronizations, device operations, host time and device time put down
to the spans that `admm_lstm_torch.utils.observe.span` opens while a
profiler records (`epoch`, its weight stages `weights.x` and `weights.h`,
`sweep.interior`, `sweep.final`, the line searches' host reads `read`,
...; PERF.md lists them).

A span is a user annotation of the kineto trace, on the host, on the
clock of the device operations.  Its parent is the span around it.  A
device operation belongs to the innermost span around the host runtime
call that launched it (the kineto correlation id they share; failing
that, the PyTorch operator linked to it).  A host synchronization
(trace.SYNC_CALLS) is planned when a `read` span encloses it.  The
device's mirrors of the spans (`gpu_user_annotation` rows) are neither
operations nor busy time.

The metric files get the window's traced jobs only as trace.py's Trace,
which keeps no span; so `of(ctx)` profiles a block of its own once a run,
after the window and the correctness check and outside every timed
number: the jobs of the window's traced block (the run's `--seed`, jobs
1 .. `traced_jobs`) on a Workload of their own.  It logs the block's
syncs and operations per epoch beside the window block's, the idle gaps
by span and operator (`idle_gaps_by_span`), and where each unplanned
sync sits.  A program without spans gives no reading.
"""

from __future__ import annotations

import bisect
import json
import sys
import traceback
from typing import Dict, List, NamedTuple, Optional

from portbench import trace

WEIGHT_STAGES = ('weights.x', 'weights.h')
NO_SPAN = '(no span)'


class Event(NamedTuple):
    start: float        # microseconds
    end: float
    name: str
    kind: str           # 'span', 'mirror', 'device', 'runtime' or 'op'
    corr: int           # a runtime call's and its device operations' id;
                        # an operator's own id
    linked: int = 0     # a device operation's launching operator's id


class Reading(NamedTuple):
    """A block's totals (times in ms) and what they are divided by."""
    epochs: int                 # epochs (batched epochs) of the block
    cand_epochs: int
    reads: int                  # `read` spans
    unplanned_syncs: Optional[int]     # None: no device operation
    weight_stage_launches: Optional[int]
    weight_stage_host_ms: float
    weight_stage_device_ms: Optional[float]


def events(prof) -> List[Event]:
    """The raw kineto events of a torch.profiler session as Events.  A
    host event that is no span is a runtime call where its name is the
    CUDA runtime's or driver's (`cuda...`, `cu...`), else an operator."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == cuda
        if e.is_user_annotation():
            kind = 'mirror' if on_device else 'span'
        elif on_device:
            kind = 'device'
        else:
            kind = 'runtime' if e.name().startswith('cu') else 'op'
        out.append(Event(e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name(),
                         kind, e.correlation_id(),
                         e.linked_correlation_id() if on_device else 0))
    return out


def _split(evs):
    """trace.py's inputs: the device operations, the host events that are
    neither spans nor their device mirrors, and the host syncs."""
    device = [(e.start, e.end, e.name) for e in evs if e.kind == 'device']
    host = [(e.start, e.end, e.name) for e in evs
            if e.kind in ('op', 'runtime')]
    syncs = sum(name in trace.SYNC_CALLS for _, _, name in host)
    return device, host, syncs


class Spans:
    """The spans of a block, nested: `at(t)` is the innermost span open
    at host time t (an index, or -1), `path(i)` its names from the
    outermost, joined by '/'."""

    def __init__(self, evs: List[Event]):
        self.spans = sorted(((e.start, e.end, e.name) for e in evs
                             if e.kind == 'span'),
                            key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (_, end, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < end:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def names(self, i: int) -> List[str]:
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out[::-1]

    def path(self, i: int) -> str:
        return '/'.join(self.names(i)) if i >= 0 else NO_SPAN

    def at(self, t: float) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return i

    def within(self, i: int, names) -> bool:
        return any(n in names for n in self.names(i))


def _operators(host, starts, at: float) -> str:
    """The PyTorch operators open at time `at`, outermost first (the call
    the program made, then where it synchronized): 'aten::where >
    aten::copy_'; the innermost alone where they are one; trace.py's
    `_activity` where none is."""
    ops = []
    j = bisect.bisect_right(starts, at) - 1
    for k in range(j, max(j - 4000, -1), -1):
        start, end, name = host[k]
        if end >= at and name.startswith('aten::'):
            ops.append(name)
    if not ops:
        return trace._activity(host, starts, at)
    return ops[0] if len(ops) == 1 else f'{ops[-1]} > {ops[0]}'


def attribute(evs: List[Event], epochs: int, cand_epochs: int,
              window_s: float) -> Dict:
    """The Reading of a block's events, its trace.py Trace (`trace`) and
    the breakdowns the run logs."""
    sp = Spans(evs)
    device, host, syncs = _split(evs)
    host_sorted = sorted(host)
    host_starts = [h[0] for h in host_sorted]
    launchers = {e.corr: e.start for e in evs
                 if e.kind == 'runtime' and e.corr}
    operators = {e.corr: e.start for e in evs if e.kind == 'op' and e.corr}

    by_span: Dict[str, list] = {}      # path: [syncs, ops, device ms]

    def bump(path, syncs=0, ops=0, ms=0.0):
        row = by_span.setdefault(path, [0, 0, 0.0])
        row[0], row[1], row[2] = row[0] + syncs, row[1] + ops, row[2] + ms

    unplanned: Dict[str, int] = {}
    n_unplanned = 0
    for e in evs:
        if e.kind != 'runtime' or e.name not in trace.SYNC_CALLS:
            continue
        i = sp.at(e.start)
        bump(sp.path(i), syncs=1)
        if not sp.within(i, ('read',)):
            n_unplanned += 1
            where = (f'{sp.path(i)} > '
                     f'{_operators(host_sorted, host_starts, e.start)}')
            unplanned[where] = unplanned.get(where, 0) + 1

    stage_ops, stage_ms, unmatched = 0, 0.0, 0
    for e in evs:
        if e.kind != 'device':
            continue
        t = launchers.get(e.corr)
        if t is None:
            t = operators.get(e.linked)
        if t is None:
            unmatched += 1
            continue
        i = sp.at(t)
        ms = (e.end - e.start) * 1e-3
        bump(sp.path(i), ops=1, ms=ms)
        if sp.within(i, WEIGHT_STAGES):
            stage_ops += 1
            stage_ms += ms

    busy = trace._busy(device)
    gaps: Dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        key = (f'{sp.path(sp.at(mid))} > '
               f'{trace._activity(host_sorted, host_starts, mid)}')
        gaps[key] = gaps.get(key, 0.0) + (start - end) * 1e-6

    count: Dict[str, int] = {}
    host_ms: Dict[str, float] = {}
    for start, end, name in sp.spans:
        count[name] = count.get(name, 0) + 1
        host_ms[name] = host_ms.get(name, 0.0) + (end - start) * 1e-3
    on_device = bool(device)
    reading = Reading(
        epochs=epochs, cand_epochs=cand_epochs, reads=count.get('read', 0),
        unplanned_syncs=n_unplanned if on_device else None,
        weight_stage_launches=stage_ops if on_device else None,
        weight_stage_host_ms=sum(host_ms.get(n, 0.0) for n in WEIGHT_STAGES),
        weight_stage_device_ms=stage_ms if on_device else None)
    return {
        'reading': reading,
        'trace': trace.summarize(device, host, syncs, window_s),
        'spans': {n: [count[n], host_ms[n]] for n in sorted(count)},
        'by_span': by_span,
        'unplanned_syncs': sorted(unplanned.items(), key=lambda kv: -kv[1]),
        'idle_gaps_by_span': sorted(gaps.items(),
                                    key=lambda kv: -kv[1])[:10],
        'unmatched_ops': unmatched,
    }


def _log(msg: str) -> None:
    print(f'portbench: {msg}', file=sys.stderr, flush=True)


def run_seed(argv=None) -> int:
    """The run's `--seed` (run.py's command line); 0 in a process that
    has none (the CPU tests call run.run_cell)."""
    args = list(sys.argv[1:] if argv is None else argv)
    for k, a in enumerate(args):
        if a == '--seed' and k + 1 < len(args):
            return int(args[k + 1])
        if a.startswith('--seed='):
            return int(a.split('=', 1)[1])
    return 0


def of(ctx) -> Optional[Reading]:
    """The Reading of this run's span block, or None: no traced window, a
    program without spans, or a block that failed (its traceback logged).
    The first metric file to ask profiles the block; the run's context
    keeps the Reading (`ctx.spans`) for the others."""
    if not hasattr(ctx, 'spans'):
        ctx.spans = None
        if ctx.trace is not None and ctx.traced_jobs:
            try:
                ctx.spans = _profile(ctx)
            except Exception:        # a per-layer reading, not the run
                _log('span block failed: ' + traceback.format_exc())
    return ctx.spans


def _profile(ctx) -> Optional[Reading]:
    import torch

    from portbench.jobs import Workload
    device = 'cuda' if torch.cuda.is_available() else 'cpu'
    work = Workload(ctx.config, ctx.traffic, ctx.sizes, run_seed(), device)
    jobs = ctx.traffic['traced_jobs']
    _, (prof, window_s) = trace.profiled(
        lambda: [work.run(1 + k) for k in range(jobs)])
    evs = events(prof)
    epochs = work.epochs * jobs
    out = attribute(evs, epochs, epochs * work.width, window_s)
    spans = out['spans']
    if spans.get('epoch', [0])[0] == 0:
        _log('span block: the program opened no `epoch` span')
        return None
    t, old = out['trace'], ctx.trace
    per = lambda n: round(n / epochs, 3)
    traced_epochs = sum(j.epochs for j in ctx.traced_jobs)
    _log(f'span block: {jobs} jobs, {epochs} epochs, {window_s:.3f} s; '
         f'syncs/epoch {per(t.syncs)} (window block '
         f'{round(old.syncs / traced_epochs, 3)}), ops/epoch '
         f'{per(len(t.device_ops))} (window block '
         f'{round(len(old.device_ops) / traced_epochs, 3)}); '
         f'{out["unmatched_ops"]} operations without a launch')
    _log('spans (count, host ms): ' + json.dumps(spans))
    _log('by span (syncs, ops, device ms): ' + json.dumps(
        {k: [v[0], v[1], round(v[2], 3)]
         for k, v in sorted(out['by_span'].items())}))
    _log('unplanned syncs: ' + json.dumps(out['unplanned_syncs']))
    _log('idle_gaps_by_span: ' + json.dumps(out['idle_gaps_by_span']))
    return out['reading']


def per_epoch(ctx, field: str, per: str = 'epochs') -> Optional[float]:
    """`field` of the run's Reading per epoch ('epochs') or per
    candidate-epoch ('cand_epochs'); None where it has none."""
    reading = of(ctx)
    if reading is None or getattr(reading, field) is None:
        return None
    return getattr(reading, field) / getattr(reading, per)
