"""The span block's whole attribution, for the metrics that read a span by
name at any depth (`weights.upper`, `sweep.interior`, ...).

spans.py keeps of its block only the totals of its Reading, and the
per-path rows (`by_span`: syncs, device operations and device ms by the
path of span names around the launch) go to the log.  `of(ctx)` profiles
the span block as spans.py does (the run's `--seed`, jobs 1 ..
`traced_jobs`, on a Workload of its own, after the window and the
correctness check and outside every timed number), with spans.py's own
functions, and keeps the whole attribution on the run's context
(`ctx.span_paths`), and its Reading as `ctx.spans`, so that a run whose
metrics read both profiles one block.  A program without spans, or a
block that fails, gives no reading.
"""

from __future__ import annotations

import json
import traceback
from typing import Dict, Optional

from portbench import spans, trace

FIELDS = {'syncs': 0, 'ops': 1, 'device_ms': 2}


def of(ctx) -> Optional[Dict]:
    """spans.attribute's output for this run's span block, or None."""
    if not hasattr(ctx, 'span_paths'):
        ctx.span_paths = None
        if ctx.trace is not None and ctx.traced_jobs:
            try:
                ctx.span_paths = _profile(ctx)
            except Exception:        # a per-layer reading, not the run
                spans._log('span block failed: ' + traceback.format_exc())
        if not hasattr(ctx, 'spans'):
            ctx.spans = (None if ctx.span_paths is None
                         else ctx.span_paths['reading'])
    return ctx.span_paths


def _profile(ctx) -> Optional[Dict]:
    import torch

    from portbench.jobs import Workload
    device = 'cuda' if torch.cuda.is_available() else 'cpu'
    work = Workload(ctx.config, ctx.traffic, ctx.sizes, spans.run_seed(),
                    device)
    jobs = ctx.traffic['traced_jobs']
    _, (prof, window_s) = trace.profiled(
        lambda: [work.run(1 + k) for k in range(jobs)])
    epochs = work.epochs * jobs
    out = spans.attribute(spans.events(prof), epochs, epochs * work.width,
                          window_s)
    count = out['spans']
    if count.get('epoch', [0])[0] == 0:
        spans._log('span block: the program opened no `epoch` span')
        return None
    t = out['trace']
    spans._log(f'span block: {jobs} jobs, {epochs} epochs, {window_s:.3f} '
               f's; syncs/epoch {round(t.syncs / epochs, 3)}, ops/epoch '
               f'{round(len(t.device_ops) / epochs, 3)}; groups '
               f'{count.get("group", [0])[0]}; {out["unmatched_ops"]} '
               'operations without a launch')
    spans._log('spans (count, host ms): ' + json.dumps(count))
    spans._log('by span (syncs, ops, device ms): ' + json.dumps(
        {k: [v[0], v[1], round(v[2], 3)]
         for k, v in sorted(out['by_span'].items())}))
    spans._log('unplanned syncs: ' + json.dumps(out['unplanned_syncs']))
    spans._log('idle_gaps_by_span: ' + json.dumps(out['idle_gaps_by_span']))
    return out


def inside(out: Dict, name: str, field: str) -> float:
    """The total of `field` ('syncs', 'ops' or 'device_ms') over every
    span path that holds a span `name`."""
    j = FIELDS[field]
    return sum(row[j] for path, row in out['by_span'].items()
               if name in path.split('/'))


def per_epoch(ctx, name: str, field: str,
              per: str = 'epochs') -> Optional[float]:
    """`inside` of the run's span block per epoch ('epochs', batched
    epochs) or per candidate-epoch ('cand_epochs'); None where the block
    has no such span or no device operation."""
    out = of(ctx)
    if out is None or out['reading'].unplanned_syncs is None:
        return None
    if name not in out['spans']:
        return None
    return inside(out, name, field) / getattr(out['reading'], per)
