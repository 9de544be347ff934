"""GEFCOM2012 Wind track: hourly wind-farm power, 7 farms, 13,176 hours.

Counterpart of `admm_lstm_tpu/data/gefcom_wind.py`.  The reference
bundles the full GEFCOM2012 Wind data
(datasets/GEFCOM2012_Data/Wind/train.csv: per-hour normalized power of
wind farms wp1..wp7, already in [0, 1], no missing values) but never loads
it.  This loader serves it as an energy-forecasting dataset: sliding
`window`-hour inputs predicting the next hour's power, with a
chronological (leakage-free) train/validation split.

`load` serves one farm; `load_scenarios` all seven farms with a leading
scenario axis S=7.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, 'datasets', 'GEFCOM2012_Data',
                            'Wind', 'train.csv')

NUM_FARMS = 7


def _read_power(path: str | None = None) -> np.ndarray:
    """(hours, 7) float32 in [0, 1]."""
    path = path or DEFAULT_PATH
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f'GEFCOM2012 Wind train.csv not found at {path}')
    with open(path) as f:
        rows = f.read().strip().split('\n')[1:]
    return np.asarray([[float(v) for v in r.split('\t')[1:]] for r in rows],
                      np.float32)


def _windows(series: np.ndarray, window: int, train_ratio: float = 0.8):
    """Sliding windows -> next-hour target; chronological split."""
    xs = np.stack([series[i:i + window] for i in
                   range(len(series) - window)])[..., None]
    ys = series[window:][:, None]
    n_train = round(len(xs) * train_ratio)
    return (xs[:n_train], ys[:n_train], xs[n_train:], ys[n_train:])


def load(num_train=None, num_val=None, farm: int = 1, window: int = 24,
         path: str | None = None
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    if not 1 <= farm <= NUM_FARMS:
        raise ValueError(f'farm must be in 1..{NUM_FARMS}, got {farm}')
    tx, ty, vx, vy = _windows(_read_power(path)[:, farm - 1], window)
    if num_train:
        tx, ty = tx[:num_train], ty[:num_train]
    if num_val:
        vx, vy = vx[:num_val], vy[:num_val]
    return tx, ty, vx, vy


def load_scenarios(window: int = 24, path: str | None = None, num_train=None,
                   num_val=None):
    """All 7 farms as a scenario batch: (7, B, window, 1) / (7, B, 1)."""
    power = _read_power(path)
    parts = [_windows(power[:, f], window) for f in range(NUM_FARMS)]
    xs, ys, vxs, vys = (np.stack([p[j] for p in parts]) for j in range(4))
    if num_train:
        xs, ys = xs[:, :num_train], ys[:, :num_train]
    if num_val:
        vxs, vys = vxs[:, :num_val], vys[:, :num_val]
    return xs, ys, vxs, vys
