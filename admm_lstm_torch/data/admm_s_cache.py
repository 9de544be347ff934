"""Readers for the reference's on-disk ADMM-LSTM-S trajectory formats.

The reference's comparison harness consumes pre-recorded ADMM-LSTM-S loss
curves instead of re-running the slow trainer (comparison.py:151-165); the
trainer writes them in two formats (ADMMLSTMS/main.py:344-359):

  1. `results.py` — a Python literal `admm_s_loss = {"name": ...,
     "train_loss": [...], "val_loss": [...]}`.
  2. `ADMM-LSTM.<dataset>` — one `train_loss test_loss` float pair per
     line, one line per iteration.

`load_admm_s_cache` parses either (sniffed by content) into the trajectory
dict `run_comparison(admm_s_cached=...)` accepts, so the single published
numeric trajectory in the whole reference (101 GEFCOM2012 rows) serves as
a recorded oracle here.

The port's own copy of `admm_lstm_tpu/data/admm_s_cache.py` (pure Python).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List


def _parse_results_py(text: str) -> Dict[str, object]:
    """Parse the `admm_s_loss = {...}` literal without executing code."""
    tree = ast.parse(text)
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, 'id', None) == 'admm_s_loss'
                        for t in node.targets)):
            value = ast.literal_eval(node.value)
            return {
                'name': str(value.get('name', 'ADMM-LSTM-S')),
                'train_loss': [float(v) for v in value['train_loss']],
                'val_loss': [float(v) for v in value['val_loss']],
            }
    raise ValueError('no `admm_s_loss = {...}` assignment found')


def _parse_pairs(text: str) -> Dict[str, object]:
    """Parse the two-column `train test` per-iteration format."""
    train: List[float] = []
    val: List[float] = []
    for line_no, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) != 2:
            raise ValueError(f'line {line_no}: expected `train test`, '
                             f'got {line!r}')
        train.append(float(parts[0]))
        val.append(float(parts[1]))
    if not train:
        raise ValueError('empty trajectory file')
    return {'name': 'ADMM-LSTM-S', 'train_loss': train, 'val_loss': val}


def load_admm_s_cache(path: str) -> Dict[str, object]:
    """Load a cached ADMM-LSTM-S trajectory in either reference format.

    Returns {'name', 'train_loss', 'val_loss'} with equal-length float
    lists, directly usable as `run_comparison(admm_s_cached=...)`.
    """
    with open(path) as f:
        text = f.read()
    out = (_parse_results_py(text) if 'admm_s_loss' in text
           else _parse_pairs(text))
    if len(out['train_loss']) != len(out['val_loss']):
        raise ValueError(f'{os.path.basename(path)}: train/val lengths '
                         f'differ ({len(out["train_loss"])} vs '
                         f'{len(out["val_loss"])})')
    return out
