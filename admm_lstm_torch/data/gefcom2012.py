"""GEFCOM2012 load-history dataset (24-hour sliding windows).

Counterpart of `admm_lstm_tpu/data/gefcom2012.py` (reference
dataset.py:122-292): the CSV `Load/Load_history.csv` has 24 hourly
columns h1..h24 per day-row; for a requested day range [day1, day2] each
of the 24 start offsets per day yields a 24-step window (crossing into
the next day) with the target being the same offset in the following
day; everything is normalized by the global maximum over the parsed
range.

`Load_history.csv` is not in the repository; download the GEFCOM2012
archive and place it at datasets/GEFCOM2012_Data/Load/Load_history.csv,
or point `path` (the CLI: --data_dir) at the directory holding `Load/`.

A reference quirk is deliberately not replicated, as in the JAX package:
dataset.py:289 fills `data_list[day - day1]`, which shifts every row
after the first by one; this loader uses contiguous windows.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, 'datasets', 'GEFCOM2012_Data')


def _read_days(csv_path: str, day1: int, day2: int
               ) -> Tuple[List[List[float]], float]:
    """Rows day1-1 .. day2+1 of the 24 hourly columns (the windows need
    the following day) and the maximum over everything read
    (dataset.py:273-292)."""
    rows, maximum = [], 0.0
    with open(csv_path, 'r') as f:
        reader = csv.DictReader(f)
        cols = [f'h{i}' for i in range(1, 25)]
        for day, row in enumerate(reader):
            if day < day1 - 1:
                continue
            vals = [float(str(row[c]).replace(',', '')) for c in cols]
            maximum = max(maximum, max(vals))
            rows.append(vals)
            if day == day2 + 1:
                break
    return rows, maximum


def load(path: str | None = None, train_days: Tuple[int, int] = (1, 20),
         val_days: Tuple[int, int] = (21, 30)
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    path = path or DEFAULT_DIR
    csv_path = os.path.join(path, 'Load', 'Load_history.csv')
    if not os.path.isfile(csv_path):
        raise FileNotFoundError(
            f'GEFCOM2012 Load/Load_history.csv is not present under {path}. '
            f'Download the GEFCOM2012 data and place it under '
            f'datasets/GEFCOM2012_Data/Load/.')

    def build(day1: int, day2: int):
        rows, maximum = _read_days(csv_path, day1, day2)
        data = np.asarray(rows, np.float32) / maximum
        xs, ys = [], []
        # dataset.py:247-258: for each day and each of 24 start hours, a
        # 24-long window spanning into the next day; target = next day,
        # same hour.
        for day in range(min(len(data) - 1, day2 - day1)):
            flat = np.concatenate([data[day], data[day + 1]])
            for start in range(24):
                xs.append(flat[start:start + 24])
                ys.append(data[day + 1][start])
        x = np.stack(xs)[..., None].astype(np.float32)
        y = np.asarray(ys, np.float32)[:, None]
        return x, y

    train_x, train_y = build(*train_days)
    val_x, val_y = build(*val_days)
    return train_x, train_y, val_x, val_y
