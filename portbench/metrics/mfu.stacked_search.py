"""The whole stacked epoch's share of the chip's peak: the operations of
the window's unprofiled stacked rho searches (models/stacked_lstm.py's
epoch_ops, per candidate-epoch) per second, over the configuration's
peak (roofline.py)."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
