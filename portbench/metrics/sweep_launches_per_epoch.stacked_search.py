"""Device operations launched inside the stacked sweep (`sweep.interior`:
its fixed products and the Python loop over t and the layers) per
batched epoch of the span block's stacked rho searches (span_paths.py):
the host's issue work, which the candidate axis does not divide."""
from portbench import span_paths


def read(ctx):
    return span_paths.per_epoch(ctx, 'sweep.interior', 'ops')
