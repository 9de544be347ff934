"""HAR: UCI Human Activity Recognition (561 features, resampled length 10).

Counterpart of `admm_lstm_tpu/data/har.py` (reference dataset.py:634-733):
per-activity contiguous segments of the X/y files are resampled to a
fixed window via `np.linspace` indexing and labels are one-hot encoded.
The raw files are not in the repository (the reference expects
datasets/HAR/{X,y}_{train,test}.txt); download them from
https://archive.ics.uci.edu/dataset/240/human+activity+recognition+using+smartphones
and point `path` (the CLI: --data_dir) at the directory.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, 'datasets', 'HAR')


def _segment_lengths(labels: np.ndarray) -> List[int]:
    """Lengths of maximal constant-label runs (dataset.py:679-691)."""
    lengths, current, prev = [], 0, None
    for y in labels:
        if y != prev:
            if current > 0:
                lengths.append(current)
            current, prev = 1, y
        else:
            current += 1
    lengths.append(current)
    return lengths


def _process(x_path: str, y_path: str, minimal_window: int = 10
             ) -> Tuple[np.ndarray, np.ndarray]:
    x = np.loadtxt(x_path, dtype=np.float32)
    y = np.loadtxt(y_path, dtype=np.int64)
    if len(x) != len(y):
        raise ValueError(f'length mismatch {len(x)} vs {len(y)} between '
                         f'{x_path} and {y_path}')
    xs, ys, i = [], [], 0
    for seg_len in _segment_lengths(y):
        if seg_len >= minimal_window:
            idx = np.linspace(i, i + seg_len - 1, minimal_window).astype(int)
            xs.append(x[idx])
            ys.append(y[i])
        i += seg_len
    features = np.stack(xs).astype(np.float32)
    labels = np.asarray(ys)
    one_hot = np.eye(labels.max() + 1, dtype=np.float32)[labels]
    return features, one_hot


def load(path: str | None = None, minimal_window: int = 10
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    path = path or DEFAULT_DIR
    if not os.path.isfile(os.path.join(path, 'X_train.txt')):
        raise FileNotFoundError(
            f'HAR data files (X_train.txt etc.) not found in {path}. '
            f'Download the UCI HAR dataset and place '
            f'X_train/y_train/X_test/y_test.txt under datasets/HAR/.')
    train_x, train_y = _process(os.path.join(path, 'X_train.txt'),
                                os.path.join(path, 'y_train.txt'),
                                minimal_window)
    test_x, test_y = _process(os.path.join(path, 'X_test.txt'),
                              os.path.join(path, 'y_test.txt'),
                              minimal_window)
    # Align class axes if a class is absent from one split.
    width = max(train_y.shape[1], test_y.shape[1])

    def pad(a):
        return np.pad(a, ((0, 0), (0, width - a.shape[1]))).astype(np.float32)

    return train_x, pad(train_y), test_x, pad(test_y)
