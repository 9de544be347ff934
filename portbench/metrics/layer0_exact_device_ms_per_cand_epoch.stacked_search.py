"""Device ms of the operations launched inside layer 0's exact weight
stages (`weights.x`, `weights.h` spans: the Gram stacks, first-order
terms and Cholesky solves of variants/stacked._layer0_weight_phase) per
candidate-epoch of the span block's stacked rho searches
(span_paths.py)."""
from portbench import span_paths


def read(ctx):
    out = span_paths.of(ctx)
    if out is None or out['reading'].weight_stage_device_ms is None:
        return None
    return out['reading'].weight_stage_device_ms / out['reading'].cand_epochs
