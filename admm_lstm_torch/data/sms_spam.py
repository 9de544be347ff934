"""SMS Spam Collection loader (char-level one-hot sequences).

Counterpart of `admm_lstm_tpu/data/sms_spam.py`.  The reference carries
this dataset only as a stub that raises (dataset.py:974-983) while it
ships the raw UCI data and a tuned parameter set (parameters.py:44-47).
This loader implements the stub's documented pipeline
(dataset.py:984-1069): normalize and clean the text, drop messages longer
than `maximum_length` characters, one-hot encode each character over the
95-symbol printable alphabet (unknown characters map to the zero vector),
pad to the longest kept message, one-hot the ham/spam label, and split
4:1 after a seeded shuffle.

Shapes: train (B, T, 95) / (B, 2), val likewise; T <= maximum_length.
"""

from __future__ import annotations

import html
import os
import re
import string
import unicodedata
from typing import Tuple

import numpy as np

_ALPHABET = (string.ascii_lowercase + string.ascii_uppercase + string.digits
             + string.punctuation + ' ')
_CHAR_TO_NUM = {c: i for i, c in enumerate(_ALPHABET)}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATH = os.path.join(_REPO_ROOT, 'datasets', 'SMSSpamRecognition',
                            'SMSSpamCollection')


def _preprocess(text: str) -> str:
    """The stub's cleanup chain (dataset.py:1012-1029)."""
    text = unicodedata.normalize('NFKD', text)
    text = ''.join(c for c in text if not unicodedata.combining(c))
    text = html.unescape(text)
    text = re.sub(r'<.*?>', '', text)
    text = re.sub(r'\s+', ' ', text)
    text = re.sub(r'[—–-]', ' ', text)
    text = re.sub(r'http\S+|www\S+', 'URL', text)
    text = re.sub(r'\S+@\S+', 'EMAIL', text)
    text = re.sub(r'[?!;]', '.', text)
    text = re.sub(r'£', '$', text)
    text = re.sub(r'[‘’“”]', "'", text)
    return text.lower()


def load(num_train=None, num_val=None, path: str | None = None,
         maximum_length: int = 25, seed: int = 0
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    path = path or DEFAULT_PATH
    if not os.path.isfile(path):
        raise FileNotFoundError(f'SMSSpamCollection not found at {path}')

    pattern = re.compile(r'(?P<label>\w+)\s+(?P<text>[\w\W]+)')
    samples = []
    with open(path, 'r', encoding='utf-8') as f:
        for line in f:
            m = pattern.match(line.strip())
            if not m or m.group('label') not in ('ham', 'spam'):
                continue
            text = _preprocess(m.group('text'))
            if len(text) > maximum_length:
                continue
            samples.append((text, 0 if m.group('label') == 'ham' else 1))

    t_max = max(len(t) for t, _ in samples)
    x = np.zeros((len(samples), t_max, len(_ALPHABET)), np.float32)
    y = np.zeros((len(samples), 2), np.float32)
    for i, (text, label) in enumerate(samples):
        for j, ch in enumerate(text):
            k = _CHAR_TO_NUM.get(ch)
            if k is not None:
                x[i, j, k] = 1.0
        y[i, label] = 1.0

    idx = np.random.default_rng(seed).permutation(len(samples))
    x, y = x[idx], y[idx]
    n_train = round(len(samples) * 4 / 5)
    tx, ty = x[:n_train], y[:n_train]
    vx, vy = x[n_train:], y[n_train:]
    if num_train:
        tx, ty = tx[:num_train], ty[:num_train]
    if num_val:
        vx, vy = vx[:num_val], vy[:num_val]
    return tx, ty, vx, vy
