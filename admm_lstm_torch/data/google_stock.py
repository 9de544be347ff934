"""GoogleStock dataset: windowed next-step regression over GOOG daily prices.

Reproduces the reference loader exactly (dataset.py:386-443): column 5 as
input series, column 4 as target series, rows 1..4705; both max-normalized;
sliding windows of 10 steps; train = windows ending at rows 10..4233
(4224 samples), test = rows 4244..4704 (461 samples).  Reads the bundled
.xls via the native BIFF reader (data/xls.py) instead of xlrd.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from admm_lstm_torch.data.xls import open_workbook

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, 'datasets', 'GoogleStock', 'GOOG.xls')

WINDOW = 10
_N_ROWS = 4705
_TRAIN_END = 4234
_TEST_START = 4244


def load(path: str | None = None
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    path = path or DEFAULT_PATH
    if not os.path.isfile(path):
        raise FileNotFoundError(f'GOOG.xls not found at {path}')
    sheet = open_workbook(path).sheet_by_index(0)

    xs = np.asarray([sheet.cell_value(i, 5) for i in range(1, _N_ROWS + 1)],
                    dtype=np.float32)
    ys = np.asarray([sheet.cell_value(i, 4) for i in range(1, _N_ROWS + 1)],
                    dtype=np.float32)
    xs = xs / xs.max()
    ys = ys / ys.max()

    def windows(lo: int, hi: int):
        idx = np.arange(lo, hi)
        x = np.stack([xs[i - WINDOW:i] for i in idx])[..., None]
        y = ys[idx][:, None]
        return x.astype(np.float32), y.astype(np.float32)

    train_x, train_y = windows(WINDOW, _TRAIN_END)
    test_x, test_y = windows(_TEST_START, _N_ROWS)
    return train_x, train_y, test_x, test_y
