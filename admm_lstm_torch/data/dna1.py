"""DNA1: UCI Molecular Biology promoter gene sequences (binary, T=57).

Counterpart of `admm_lstm_tpu/data/dna1.py` (reference dataset.py:919-971):
one-hot ACGT encoding of 106 sequences of length 57, labels +/- as 1/0,
shuffled 4:1 train/test split.  The reference shuffles with
`torch.randperm` under the process-global torch seed (dataset.py:967);
this loader draws the same permutation from its own
`torch.Generator().manual_seed(seed)`, so the split matches the
reference's seed-0 runs sample for sample and the global RNG is left
alone.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np
import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, 'datasets', 'DNA1', 'promoters.data')

_ONE_HOT = {
    'a': np.array([1, 0, 0, 0], np.float32),
    'c': np.array([0, 1, 0, 0], np.float32),
    'g': np.array([0, 0, 1, 0], np.float32),
    't': np.array([0, 0, 0, 1], np.float32),
}
_PATTERN = re.compile(r'(?P<p_sym>[+-]),[\w\W\d]*,\s+(?P<seq>[actg]+)')


def load(path: str | None = None, seed: int = 0, torch_shuffle: bool = True
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    path = path or DEFAULT_PATH
    if not os.path.isfile(path):
        raise FileNotFoundError(f'promoters.data not found at {path}')

    features, labels = [], []
    with open(path, 'r') as f:
        for line in f:
            m = _PATTERN.match(line.strip())
            if not m:
                continue
            features.append(np.stack([_ONE_HOT[s] for s in m.group('seq')]))
            labels.append(1.0 if m.group('p_sym') == '+' else 0.0)
    x = np.stack(features).astype(np.float32)           # (106, 57, 4)
    y = np.asarray(labels, np.float32)[:, None]          # (106, 1)

    n = len(x)
    if torch_shuffle:
        gen = torch.Generator().manual_seed(seed)
        perm = torch.randperm(n, generator=gen).numpy()
    else:
        perm = np.random.default_rng(seed).permutation(n)
    x, y = x[perm], y[perm]
    n_train = round(n * 4 / 5)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]
