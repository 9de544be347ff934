"""The one-layer LSTM of Fast ADMM-LSTM: the port's `api.train` and
`tune.search_rho` against the plain reference's `train_run` and
`rho_search` (reference/admm_lstm.py), from the same weights and data.

The configuration's `solver` block gives the program's ADMMConfig (its
`preset`, 'default' or 'turbo', and the fields it sets), `control` the
fields that switch on its lower-precision path, and `reference_rules`
the reference's Rules.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import flops, weights as draws
from portbench.reference import admm_lstm as ref

RHO_KEYS = ref.RHO_KEYS


def weights(seed: int, job: int, sizes: dict, device):
    """(wx (4, I, H), wh (4, H, H), wy (H, O)) of job `job`, Xavier-normal
    as the port's and the reference's `init_lstm_params` draw them
    (blocks/lstm.py:23-29)."""
    i, h, o = sizes['I'], sizes['H'], sizes['O']
    blocks = draws.xavier_blocks(seed, job, [(i, h)] * 4 + [(h, h)] * 4
                                 + [(h, o)], device)
    return (torch.stack(blocks[:4]), torch.stack(blocks[4:8]),
            blocks[8].contiguous())


def admm_config(config: dict, sizes: dict, epochs: int, control: bool):
    from admm_lstm_torch.utils.config import ADMMConfig
    solver = dict(config['solver'])
    if control:
        solver.update(config['control'])
    make = {'default': ADMMConfig,
            'turbo': ADMMConfig.turbo}[solver.pop('preset')]
    return make(hidden_size=sizes['H'], epochs=epochs, **solver)


def _parameter_set(config: dict) -> dict:
    return {'rho': dict(config['rho']), 'beta': dict(config['beta'])}


def train(config, sizes, data, weights, epochs, device, control=False):
    from admm_lstm_torch import api
    from admm_lstm_torch.models.lstm import LSTMParams
    res = api.train(*data, _parameter_set(config),
                    config=admm_config(config, sizes, epochs, control),
                    params=LSTMParams(*weights), log_every=0, device=device)
    return {'train': np.asarray(res['train_loss'], np.float64),
            'val': np.asarray(res['val_loss'], np.float64),
            'weights': tuple(res['params'])}


def search(config, sizes, data, weights, candidates, epochs, device,
           control=False):
    from admm_lstm_torch import tune
    from admm_lstm_torch.models.lstm import LSTMParams
    res = tune.search_rho(*data, _parameter_set(config),
                          config=admm_config(config, sizes, epochs, control),
                          candidates=candidates, epochs=epochs,
                          params=LSTMParams(*weights), device=device)
    return {'train': np.asarray(res['train_losses'], np.float64),
            'val': np.asarray(res['val_losses'], np.float64),
            'order': np.asarray(res['order'])}


def _reference_layout(data):
    """x (T, I, B), y (O, B), x_all (T, I, B + Bv), vy (O, Bv)."""
    tx, ty, vx, vy = data
    x = tx.permute(1, 2, 0).contiguous()
    x_all = torch.cat([x, vx.permute(1, 2, 0)], dim=-1).contiguous()
    return x, ty.T.contiguous(), x_all, vy.T.contiguous()


def reference_train(config, data, weights, epochs):
    x, y, x_all, v = _reference_layout(data)
    rules = ref.Rules(**config['reference_rules'])
    rho = [config['rho'][k] for k in RHO_KEYS]
    train, val, final = ref.train_run(*weights, x, y, x_all, v, rho,
                                      config['beta'], epochs, rules)
    return {'train': train.astype(np.float64),
            'val': val.astype(np.float64), 'weights': final,
            'initial': weights}


def reference_search(config, data, weights, candidates, epochs):
    x, y, x_all, v = _reference_layout(data)
    rules = ref.Rules(**config['reference_rules'])
    rho = [config['rho'][k] for k in RHO_KEYS]
    train, val = ref.rho_search(*weights, x, y, x_all, v, rho, candidates,
                                config['beta'], epochs, rules)
    return {'train': train.astype(np.float64),
            'val': val.astype(np.float64)}


def epoch_ops(sizes: dict, reference_rules: dict) -> float:
    return flops.epoch_ops(sizes, reference_rules.get('exact_max_dim', 0))


def fault_targets():
    from admm_lstm_torch import tune
    from admm_lstm_torch.core import step
    return {'step': ((step, 'admm_step_im'), (tune, 'admm_step_im')),
            'loss': ((step, 'train_val_mse_im'), (tune, 'train_val_mse_im'))}
