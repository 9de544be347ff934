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


def load_hierarchical(batch: int = 512, seq_len: int = 16,
                      input_size: int = 8, output_size: int = 1,
                      val_batch: int = 128, seed: int = 0, width: int = 8
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compositional sequence regression: the target is a two-stage
    nonlinear read-out of a nonlinear per-step feature, the hypothesis
    class where depth should pay at a fixed parameter count (the plain
    `load` target is a single shallow nonlinearity)."""
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((input_size, width)).astype(np.float32) * 0.7
    w2 = rng.standard_normal((width, width)).astype(np.float32) * 1.2
    v2 = rng.standard_normal((width, output_size)).astype(np.float32)
    tw = np.linspace(0.2, 1.0, seq_len, dtype=np.float32)[None, :, None]

    def make(n):
        x = rng.standard_normal((n, seq_len, input_size)).astype(np.float32)
        x = np.cumsum(x, axis=1) * 0.2
        u = np.tanh(x @ w1)                      # (n, T, width) stage 1
        s = (u * tw).mean(1)                     # temporal pooling
        y = np.tanh(np.tanh(s @ w2) @ v2)        # stage 2 composition
        y = y.astype(np.float32)
        y += 0.01 * rng.standard_normal(y.shape).astype(np.float32)
        return x, y

    train_x, train_y = make(batch)
    val_x, val_y = make(val_batch)
    return train_x, train_y, val_x, val_y
