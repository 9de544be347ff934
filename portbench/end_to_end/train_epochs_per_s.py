"""Epochs of every training run of the window over all of its time."""
from portbench import readers


def read(ctx):
    return readers.rate(ctx, 'epochs')
