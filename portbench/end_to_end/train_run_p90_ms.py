"""The 90th percentile (nearest rank) of the wall time of the window's
whole training runs, each from weights to returned losses."""
from portbench import readers


def read(ctx):
    return readers.percentile_ms(ctx, 90)
