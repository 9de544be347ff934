"""Synthetic sequence-regression data for tests and benchmarks.

Not in the reference; used wherever a dataset-shaped array quadruple is
needed hermetically (unit tests, multichip dry runs, kernels benchmarks).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load(batch: int = 512, seq_len: int = 10, input_size: int = 1,
         output_size: int = 1, val_batch: int = 128, seed: int = 0
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Noisy auto-regressive series: y = mean of a nonlinear filter of x."""
    rng = np.random.default_rng(seed)

    def make(n):
        x = rng.standard_normal((n, seq_len, input_size)).astype(np.float32)
        x = np.cumsum(x, axis=1) * 0.1
        weights = np.linspace(0.1, 1.0, seq_len, dtype=np.float32)
        y = np.tanh((x.mean(-1) * weights).sum(-1, keepdims=True) * 0.5)
        y = np.repeat(y, output_size, -1).astype(np.float32)
        y += 0.01 * rng.standard_normal(y.shape).astype(np.float32)
        return x, y

    train_x, train_y = make(batch)
    val_x, val_y = make(val_batch)
    return train_x, train_y, val_x, val_y
