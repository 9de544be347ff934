"""The traffic generator: the jobs a cell runs, on the program and on the
plain reference.

A traffic mix is a data file (`traffic/<name>.json`) of one of two kinds:

  * `train`: back-to-back training runs of `epochs` epochs, each from
    weights of its own (the model's `weights`), on the configuration's
    data, which is made once and stays on the device;
  * `rho_search`: back-to-back rho searches of `epochs` epochs over the
    candidates that `multipliers` and `keys` make from the configuration's
    rho (the rule of `tune.candidate_grid`, frozen here), each search from
    weights of its own.

`warmup_epochs` sets the short job of the set-up, `checked_jobs` how many
jobs of the window the reference recomputes, `traced_jobs` how many whole
jobs a traced run profiles.  What a job runs, on either side, is the
configuration's model's (models/).
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence

import numpy as np

from portbench import spec


def candidate_grid(rho: Dict[str, float], multipliers, keys,
                   rho_keys: Sequence[str]) -> np.ndarray:
    """(N, len(rho_keys)) float32 rho vectors in `rho_keys` order: the base
    rho with each of `keys` scaled by every combination of `multipliers`
    (the first key varying slowest)."""
    base = np.asarray([rho[k] for k in rho_keys], np.float32)
    out = []
    for combo in itertools.product(multipliers, repeat=len(keys)):
        vec = base.copy()
        for k, m in zip(keys, combo):
            vec[rho_keys.index(k)] *= m
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
        self.control = control
        self.model = spec.model(config['model'])
        self.kind = traffic['kind']
        if self.kind not in ('train', 'rho_search'):
            raise ValueError(f'unknown traffic kind {self.kind!r}')
        self.epochs = traffic['epochs']
        self.data = spec.data_source(config['data']['kind']).load(
            {**config['data'], **sizes}, seed, device)
        self.candidates = (candidate_grid(config['rho'],
                                          traffic['multipliers'],
                                          traffic['keys'],
                                          self.model.RHO_KEYS)
                           if self.kind == 'rho_search' else None)
        self.width = 1 if self.candidates is None else len(self.candidates)

    def weights(self, job: int):
        return self.model.weights(self.seed, job, self.sizes, self.device)

    def run(self, job: int, epochs: int = 0) -> dict:
        """Job `job` on the program: its answers, on the host but for the
        final weights."""
        epochs = epochs or self.epochs
        w = self.weights(job)
        if self.kind == 'train':
            return self.model.train(self.config, self.sizes, self.data, w,
                                    epochs, self.device, self.control)
        return self.model.search(self.config, self.sizes, self.data, w,
                                 self.candidates, epochs, self.device,
                                 self.control)

    def reference(self, job: int) -> dict:
        """Job `job` recomputed by the plain reference from the same
        weights and data."""
        w = self.weights(job)
        if self.kind == 'train':
            return self.model.reference_train(self.config, self.data, w,
                                              self.epochs)
        return self.model.reference_search(self.config, self.data, w,
                                           self.candidates, self.epochs)
