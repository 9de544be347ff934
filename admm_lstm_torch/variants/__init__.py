"""Variants of the ADMM-LSTM family beyond the single-layer core."""
