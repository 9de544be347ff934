"""YahooFinance dataset (AAPL close prices 2018-2024, window 60).

Counterpart of `admm_lstm_tpu/data/yahoo_finance.py`.  The reference
downloads via yfinance and caches tensors under datasets/YahooFinance/*.pt
(dataset.py:446-503); the repository ships that cache (train (1360,60,1),
test (340,60,1)) of plain float32 tensors, so it loads with
`torch.load(..., weights_only=True)`.  Without the cache, raw close prices
rebuild the same MinMax-scaling + window-60 + shuffled 80/20 split.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CACHE_DIR = os.path.join(_REPO_ROOT, 'datasets', 'YahooFinance')
_NAMES = ('train_x', 'train_y', 'test_x', 'test_y')


def load(cache_dir: str | None = None
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    d = cache_dir or _CACHE_DIR
    if not all(os.path.isfile(os.path.join(d, f'{n}.pt')) for n in _NAMES):
        raise FileNotFoundError(
            f'YahooFinance cache (*.pt) not found in {d}; the original '
            f'pipeline needs network access via yfinance (dataset.py:460).')
    return tuple(
        np.asarray(torch.load(os.path.join(d, f'{n}.pt'), map_location='cpu',
                              weights_only=True).numpy(), np.float32)
        for n in _NAMES)


def load_scenarios(num_scenarios: int = 4, cache_dir: str | None = None,
                   series: list | None = None, seed: int = 0):
    """Scenario batches with a leading scenario axis S: (xs, ys, vxs, vys).

    With `series` (a list of raw close-price arrays, one per ticker), each
    series becomes one scenario through the reference pipeline.  Without
    it, the cached window set splits into `num_scenarios` disjoint batches
    of the same shapes.
    """
    if series is not None:
        parts = [build_from_series(np.asarray(s), seed=seed) for s in series]
        n_tr = min(p[0].shape[0] for p in parts)
        n_va = min(p[2].shape[0] for p in parts)
        return (np.stack([p[0][:n_tr] for p in parts]),
                np.stack([p[1][:n_tr] for p in parts]),
                np.stack([p[2][:n_va] for p in parts]),
                np.stack([p[3][:n_va] for p in parts]))

    tx, ty, vx, vy = load(cache_dir)
    rng = np.random.default_rng(seed)
    ptr, pva = rng.permutation(len(tx)), rng.permutation(len(vx))
    n_tr = len(tx) // num_scenarios
    n_va = len(vx) // num_scenarios
    if n_tr == 0 or n_va == 0:
        raise ValueError(
            f'num_scenarios={num_scenarios} exceeds the available windows '
            f'(train {len(tx)}, val {len(vx)}); each scenario needs at '
            f'least one sample of each split')

    def split(a, perm, n):
        return np.stack([a[perm[s * n:(s + 1) * n]]
                         for s in range(num_scenarios)])

    return (split(tx, ptr, n_tr), split(ty, ptr, n_tr),
            split(vx, pva, n_va), split(vy, pva, n_va))


def build_from_series(closes: np.ndarray, window: int = 60, seed: int = 0,
                      train_ratio: float = 0.8):
    """Rebuild from a raw close-price series (dataset.py:465-503)."""
    lo, hi = closes.min(), closes.max()
    scaled = ((closes - lo) / (hi - lo)).astype(np.float32).reshape(-1, 1)
    xs = np.stack([scaled[i:i + window] for i in range(len(scaled) - window)])
    ys = np.stack([scaled[i + window] for i in range(len(scaled) - window)])
    perm = np.random.default_rng(seed).permutation(len(xs))
    xs, ys = xs[perm], ys[perm]
    n_train = round(len(xs) * train_ratio)
    return (xs[:n_train], ys[:n_train], xs[n_train:], ys[n_train:])
