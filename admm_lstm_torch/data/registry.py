"""Dataset registry: names -> loader + tuned parameter set + display title.

Counterpart of `admm_lstm_tpu/data/registry.py`.  This slice of the port
serves GoogleStock (the reference's default run) and Synthetic; the other
names the JAX package knows raise "not yet ported".  Loaders return numpy
float32 arrays (train_x, train_y, val_x, val_y) with shapes (B,T,I),
(B,O), (Bv,T,I), (Bv,O).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ParameterSet

supported_datasets = ['GoogleStock', 'Synthetic']
# Served by the JAX package; their loaders arrive in a later slice.
not_yet_ported = ['GEFCOM2012', 'GEFCOM2012Wind', 'YahooFinance', 'HAR',
                  'DNA1', 'SMSSpam']

_TITLES = {
    'GoogleStock': 'Google Stock',
    'Synthetic': 'Synthetic',
}


def _loader(name: str) -> Callable:
    if name == 'GoogleStock':
        from admm_lstm_torch.data.google_stock import load
    elif name == 'Synthetic':
        from admm_lstm_torch.data.synthetic import load
    elif name in not_yet_ported:
        raise ValueError(f'Dataset {name!r} is not yet ported to '
                         f'admm_lstm_torch; choose from {supported_datasets}')
    else:
        raise ValueError(f'Dataset {name!r} is not supported; '
                         f'choose from {supported_datasets}')
    return load


def load_dataset(name: str, num_train: Optional[int] = None,
                 num_val: Optional[int] = None, **loader_kwargs
                 ) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
                            ParameterSet, str]:
    """Load arrays, clip to requested sample counts (demo.py:175-186),
    and return the tuned parameter set + title."""
    train_x, train_y, val_x, val_y = _loader(name)(**loader_kwargs)
    if isinstance(num_train, int) and num_train < len(train_x):
        train_x, train_y = train_x[:num_train], train_y[:num_train]
    if isinstance(num_val, int) and num_val < len(val_x):
        val_x, val_y = val_x[:num_val], val_y[:num_val]
    return (train_x, train_y, val_x, val_y), parameter_set(name), _TITLES[name]
