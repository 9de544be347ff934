"""Device operations (kernels, copies, fills) per epoch of the profiled
training runs."""
from portbench import readers


def read(ctx):
    return (None if ctx.trace is None
            else readers.per_traced(ctx, len(ctx.trace.device_ops),
                                    'epochs'))
