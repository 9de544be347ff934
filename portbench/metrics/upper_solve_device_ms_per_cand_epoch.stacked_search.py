"""Device ms of the operations launched inside the upper layers' float64
ridge solves (`weights.upper` spans, variants/stacked._upper_weight_solve)
per candidate-epoch of the span block's stacked rho searches
(span_paths.py)."""
from portbench import span_paths


def read(ctx):
    return span_paths.per_epoch(ctx, 'weights.upper', 'device_ms',
                                'cand_epochs')
