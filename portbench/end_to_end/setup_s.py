"""From the start of the process to the window: imports, CUDA, data,
kernels loaded (built in a fresh checkout) and the warm-up job."""


def read(ctx):
    return ctx.setup_s
