"""Candidates x epochs of every rho search of the window over all of its
time."""
from portbench import readers


def read(ctx):
    return readers.rate(ctx, 'cand_epochs')
