"""Tuned per-dataset ADMM constants.

These are the published tunings the reference ships (parameters.py:11-91):
rho = 7 penalty coefficients (i,f,g,o,c,h,y), beta = 9 ridge coefficients
(wi,vi,wf,vf,wg,vg,wo,vo,wy; w=input-side, v=hidden-side).  They are data,
not code — matching them is required for loss-trajectory parity.
"""

from typing import Dict

from admm_lstm_torch.utils.config import ParameterSet

default_epoch = 100

_UNIFORM_BETA_8E7 = {k: 8e-7 for k in ('wi', 'vi', 'wf', 'vf', 'wg', 'vg', 'wo', 'vo', 'wy')}
_UNIFORM_BETA_1E8 = {k: 1e-8 for k in ('wi', 'vi', 'wf', 'vf', 'wg', 'vg', 'wo', 'vo', 'wy')}
_UNIFORM_BETA_8E9 = {k: 8e-9 for k in ('wi', 'vi', 'wf', 'vf', 'wg', 'vg', 'wo', 'vo', 'wy')}

example_parameter_dictionary: Dict[str, Dict[str, Dict[str, float]]] = {
    'GoogleStock': {
        'rho': {'i': 1., 'f': 1., 'g': 1., 'o': 1., 'c': 0.008, 'h': 0.00045, 'y': 0.0000562},
        'beta': dict(_UNIFORM_BETA_8E7),
    },
    'GEFCOM2012': {
        'rho': {'i': 1, 'f': 1, 'g': 1, 'o': 1, 'c': 0.1, 'h': 0.01, 'y': 0.01},
        'beta': dict(_UNIFORM_BETA_8E7),
    },
    # GEFCOM2012 Wind track (data/gefcom_wind.py) — a dataset the
    # reference bundles but never loads; tuned on TPU with three
    # vmapped successive-halving rounds (val MSE 0.0098 @30 epochs).
    'GEFCOM2012Wind': {
        'rho': {'i': 1, 'f': 1, 'g': 1, 'o': 1, 'c': 0.5625, 'h': 0.001, 'y': 0.001},
        'beta': dict(_UNIFORM_BETA_8E7),
    },
    'YahooFinance': {
        'rho': {'i': 1, 'f': 1, 'g': 1, 'o': 1, 'c': 0.1, 'h': 0.02, 'y': 0.01},
        'beta': dict(_UNIFORM_BETA_1E8),
    },
    'HAR': {
        'rho': {'i': 1.5, 'f': 1.5, 'g': 1.5, 'o': 1.5, 'c': 0.005, 'h': 8e-04, 'y': 4e-04},
        'beta': dict(_UNIFORM_BETA_8E7),
    },
    'PTB': {
        'rho': {'i': .8, 'f': .8, 'g': .8, 'o': .8, 'c': 5e-4, 'h': 5e-4, 'y': 1e-5},
        'beta': dict(_UNIFORM_BETA_8E7),
    },
    'DNA1': {
        'rho': {'i': 1., 'f': 1., 'g': 1., 'o': 1., 'c': 0.001, 'h': 0.03, 'y': 0.002},
        'beta': dict(_UNIFORM_BETA_8E9),
    },
    'SMSSpam': {
        'rho': {'i': 1.0, 'f': 1.0, 'g': 1.0, 'o': 1.0, 'c': 0.01, 'h': 0.001, 'y': 4e-05},
        'beta': dict(_UNIFORM_BETA_8E9),
    },
    # A deliberately mild tuning for synthetic smoke/bench data.
    'Synthetic': {
        'rho': {'i': 1., 'f': 1., 'g': 1., 'o': 1., 'c': 0.01, 'h': 0.001, 'y': 0.0001},
        'beta': dict(_UNIFORM_BETA_8E7),
    },
    # Tuning for the stacked N-layer variant (variants/stacked.py): the
    # z-coupled formulation wants a strong h tether (the lower layers' h
    # must stay near o*tanh(c) because it feeds the layer above) and a
    # moderate pre-activation penalty rho_z ('z' key, read only by the
    # stacked variant).  Grid-searched on synthetic data, depths 2-4.
    'Stacked': {
        'rho': {'i': 1., 'f': 1., 'g': 1., 'o': 1., 'c': 0.1, 'h': 2.0,
                'y': 0.3, 'z': 1.0},
        'beta': dict(_UNIFORM_BETA_8E7),
    },
}


def parameter_set(dataset: str) -> ParameterSet:
    return ParameterSet.from_dict(example_parameter_dictionary[dataset])
