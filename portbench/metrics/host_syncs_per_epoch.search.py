"""Host synchronizations (cudaStreamSynchronize and the like, trace.py)
per epoch of the profiled rho searches (per batched epoch)."""
from portbench import readers


def read(ctx):
    return (None if ctx.trace is None
            else readers.per_traced(ctx, ctx.trace.syncs, 'epochs'))
