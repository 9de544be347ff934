"""Host wall ms inside the weight stages (`weights.x`, `weights.h` spans)
per epoch of a profiled block of training runs, on the profiled host
(spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_epoch(ctx, 'weight_stage_host_ms')
