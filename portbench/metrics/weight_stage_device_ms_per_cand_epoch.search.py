"""Device ms of the operations launched inside the weight stages
(`weights.x`, `weights.h` spans) per candidate-epoch of a profiled block
of rho searches (spans.py)."""
from portbench import spans


def read(ctx):
    return spans.per_epoch(ctx, 'weight_stage_device_ms', 'cand_epochs')
