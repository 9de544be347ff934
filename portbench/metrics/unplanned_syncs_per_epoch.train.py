"""Host synchronizations outside every `read` span (the line searches'
planned host reads) per epoch of a profiled block of training runs
(spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_epoch(ctx, 'unplanned_syncs')
