"""GoogleStock as the reference loads it (dataset.py:386-443 of
Frederick2309/ADMM-LSTM): column 5 of the bundled GOOG.xls is the input
series and column 4 the target series, rows 1..4705, each divided by its
maximum; windows of 10 steps; train = windows ending at rows 10..4233
(4224 samples), validation = rows 4244..4704 (461 samples).

The file is read with the frozen reader beside this module.  The data
does not depend on the seed.  `batch` and `val_batch` below the
published counts keep the first windows (the CPU tests' small sizes).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.data.xls import open_workbook
from portbench.spec import ROOT

WINDOW = 10
N_ROWS = 4705
TRAIN_END = 4234
VAL_START = 4244


def load(spec, seed, device):
    del seed
    sheet = open_workbook(os.path.join(ROOT, spec['file'])).sheet_by_index(0)
    column = lambda c: np.asarray(
        [sheet.cell_value(i, c) for i in range(1, N_ROWS + 1)], np.float32)
    xs, ys = column(5), column(4)
    xs, ys = xs / xs.max(), ys / ys.max()

    def windows(lo, hi, count):
        idx = np.arange(lo, hi)[:count]
        x = np.stack([xs[i - WINDOW:i] for i in idx])[..., None]
        return (torch.from_numpy(x).to(device),
                torch.from_numpy(ys[idx][:, None].copy()).to(device))

    if spec['T'] != WINDOW or spec['I'] != 1 or spec['O'] != 1:
        raise ValueError('GoogleStock has T 10, I 1, O 1')
    return (*windows(WINDOW, TRAIN_END, spec['B']),
            *windows(VAL_START, N_ROWS, spec['val']))
