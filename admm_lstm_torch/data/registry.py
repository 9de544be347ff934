"""Dataset registry: names -> loader + tuned parameter set + display title.

Counterpart of `admm_lstm_tpu/data/registry.py`, serving the same names
(the reference's `supported_datasets` + `parse_dataset` dispatch,
dataset.py:22-28, demo.py:238-264, plus 'Synthetic' for hermetic runs).
Loaders return numpy float32 arrays (train_x, train_y, val_x, val_y) with
shapes (B,T,I), (B,O), (Bv,T,I), (Bv,O).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ParameterSet

supported_datasets = ['GoogleStock', 'GEFCOM2012', 'GEFCOM2012Wind',
                      'YahooFinance', 'HAR', 'DNA1', 'SMSSpam', 'Synthetic']

# Datasets the reference carries as dead stubs that raise on use
# (dataset.py:506,535,736; demo.py:249-262).  SMSSpam is a stub there
# too (dataset.py:974) but its raw data ships, so it has a working
# loader (data/sms_spam.py).
removed_datasets = ['MNISTDataset', 'UCF101', 'PTB']

_TITLES = {
    'GoogleStock': 'Google Stock',
    'GEFCOM2012': 'GEFCOM2012',
    'GEFCOM2012Wind': 'GEFCOM2012 Wind (farm wp1)',
    'YahooFinance': 'Yahoo Finance',
    'HAR': 'HAR',
    'DNA1': 'DNA1',
    'SMSSpam': 'SMS Spam Recognition',
    'Synthetic': 'Synthetic',
}


def _loader(name: str) -> Callable:
    if name == 'GoogleStock':
        from admm_lstm_torch.data.google_stock import load
    elif name == 'GEFCOM2012':
        from admm_lstm_torch.data.gefcom2012 import load
    elif name == 'GEFCOM2012Wind':
        from admm_lstm_torch.data.gefcom_wind import load
    elif name == 'YahooFinance':
        from admm_lstm_torch.data.yahoo_finance import load
    elif name == 'HAR':
        from admm_lstm_torch.data.har import load
    elif name == 'DNA1':
        from admm_lstm_torch.data.dna1 import load
    elif name == 'SMSSpam':
        from admm_lstm_torch.data.sms_spam import load
    elif name == 'Synthetic':
        from admm_lstm_torch.data.synthetic import load
    elif name in removed_datasets:
        raise ValueError(f'{name} was removed from the supported datasets '
                         f'(kept only as tuned parameters in params.py, '
                         f'mirroring the reference); choose from '
                         f'{supported_datasets}')
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
