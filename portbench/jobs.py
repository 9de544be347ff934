"""The traffic generator: the jobs a cell runs, on the program and on the
plain reference.

A traffic mix is a data file (`traffic/<name>.json`) of one of two kinds:

  * `train`: back-to-back training runs of `epochs` epochs through the
    port's `api.train`, each from weights of its own (weights.py), on
    the configuration's data, which is made once and stays on the device;
  * `rho_search`: back-to-back `tune.search_rho` calls of `epochs`
    epochs over the candidates that `multipliers` and `keys` make from the
    configuration's rho (the rule of `tune.candidate_grid`, frozen here),
    each search from weights of its own.

`warmup_epochs` sets the short job of the set-up, `checked_jobs` how many
jobs of the window the reference recomputes, `traced_jobs` how many whole
jobs a traced run profiles.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch

from portbench import spec, weights
from portbench.reference import admm_lstm as ref


def candidate_grid(rho: Dict[str, float], multipliers, keys) -> np.ndarray:
    """(N, 7) float32 rho vectors in i, f, g, o, c, h, y order: the base
    rho with each of `keys` scaled by every combination of `multipliers`
    (the first key varying slowest)."""
    base = np.asarray([rho[k] for k in ref.RHO_KEYS], np.float32)
    out = []
    for combo in itertools.product(multipliers, repeat=len(keys)):
        vec = base.copy()
        for k, m in zip(keys, combo):
            vec[ref.RHO_KEYS.index(k)] *= m
        out.append(vec)
    return np.stack(out)


class Workload:
    """One cell's jobs at `sizes` (the configuration's, or smaller ones in
    the CPU tests) from run seed `seed`.  `control` runs the program with
    the configuration's lower-precision path switched on."""

    def __init__(self, config: dict, traffic: dict, sizes: dict, seed: int,
                 device, control: bool = False):
        self.config, self.traffic = config, traffic
        self.sizes, self.seed, self.device = sizes, seed, device
        self.kind = traffic['kind']
        if self.kind not in ('train', 'rho_search'):
            raise ValueError(f'unknown traffic kind {self.kind!r}')
        self.epochs = traffic['epochs']
        self.data = spec.data_source(config['data']['kind']).load(
            {**config['data'], **sizes}, seed, device)
        self.parameter_set = {'rho': dict(config['rho']),
                              'beta': dict(config['beta'])}
        self.candidates = (candidate_grid(config['rho'],
                                          traffic['multipliers'],
                                          traffic['keys'])
                           if self.kind == 'rho_search' else None)
        self.width = 1 if self.candidates is None else len(self.candidates)
        solver = dict(config['solver'])
        if control:
            solver.update(config['control'])
        self.preset = solver.pop('preset')
        self.solver = solver

    def admm_config(self, epochs: int):
        from admm_lstm_torch.utils.config import ADMMConfig
        make = {'default': ADMMConfig, 'turbo': ADMMConfig.turbo}[self.preset]
        return make(hidden_size=self.sizes['H'], epochs=epochs, **self.solver)

    def weights(self, job: int):
        return weights.xavier_weights(self.seed, job, self.sizes, self.device)

    def run(self, job: int, epochs: int = 0) -> dict:
        """Job `job` on the program: its answers, on the host but for the
        final weights."""
        from admm_lstm_torch import api, tune
        from admm_lstm_torch.models.lstm import LSTMParams
        epochs = epochs or self.epochs
        params = LSTMParams(*self.weights(job))
        if self.kind == 'train':
            res = api.train(*self.data, self.parameter_set,
                            config=self.admm_config(epochs), params=params,
                            log_every=0, device=self.device)
            return {'train': np.asarray(res['train_loss'], np.float64),
                    'val': np.asarray(res['val_loss'], np.float64),
                    'weights': tuple(res['params'])}
        res = tune.search_rho(*self.data, self.parameter_set,
                              config=self.admm_config(epochs),
                              candidates=self.candidates, epochs=epochs,
                              params=params, device=self.device)
        return {'train': np.asarray(res['train_losses'], np.float64),
                'val': np.asarray(res['val_losses'], np.float64),
                'order': np.asarray(res['order'])}

    def reference(self, job: int) -> dict:
        """Job `job` recomputed by the plain reference from the same
        weights and data."""
        tx, ty, vx, vy = self.data
        x = tx.permute(1, 2, 0).contiguous()                  # (T, I, B)
        x_all = torch.cat([x, vx.permute(1, 2, 0)], dim=-1).contiguous()
        y, v = ty.T.contiguous(), vy.T.contiguous()
        rules = ref.Rules(**self.config['reference_rules'])
        wx, wh, wy = self.weights(job)
        rho = [self.config['rho'][k] for k in ref.RHO_KEYS]
        if self.kind == 'train':
            train, val, final = ref.train_run(
                wx, wh, wy, x, y, x_all, v, rho, self.config['beta'],
                self.epochs, rules)
            return {'train': train.astype(np.float64),
                    'val': val.astype(np.float64), 'weights': final,
                    'initial': (wx, wh, wy)}
        train, val = ref.rho_search(wx, wh, wy, x, y, x_all, v, rho,
                                    self.candidates, self.config['beta'],
                                    self.epochs, rules)
        return {'train': train.astype(np.float64),
                'val': val.astype(np.float64)}
