"""The port trains every bundled dataset as the JAX package does: the
first epochs from the reference's recorded seed-0 weights against the
JAX step, and (slow) the recorded 30-epoch reference trajectories."""

import os

import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu import api as j_api
from admm_lstm_tpu.models.lstm import params_from_dict as j_params_from_dict
from admm_lstm_torch import api
from admm_lstm_torch.data import load_dataset
from admm_lstm_torch.models.lstm import params_from_dict
from admm_lstm_torch.utils.config import ADMMConfig

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')
GOLDENS = {'YahooFinance': 'yahoofinance_fast.npz', 'DNA1': 'dna1_fast.npz'}


def _golden(name):
    g = np.load(os.path.join(GOLDEN, GOLDENS[name]))
    return g, {k[3:]: g[k] for k in g.files if k.startswith('w0_')}


@pytest.mark.parametrize('name', sorted(GOLDENS))
def test_torch_dataset_first_epochs_match_jax(name):
    """Three epochs at full width (YahooFinance T=60, DNA1 B=85, I=4)
    against the JAX package at rtol 1e-4 (f32, summation order)."""
    (tx, ty, vx, vy), ps, _ = load_dataset(name)
    g, w = _golden(name)
    cfg = dict(epochs=3, hidden_size=int(g['hidden']))
    ref = j_api.train(tx, ty, vx, vy, ps, JConfig(**cfg),
                      params=j_params_from_dict(w), log_every=0)
    got = api.train(tx, ty, vx, vy, ps, ADMMConfig(**cfg),
                    params=params_from_dict(w), log_every=0, device='cpu')
    np.testing.assert_allclose(got['train_loss'], ref['train_loss'],
                               rtol=1e-4)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=1e-4)
    for field in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(getattr(got['params'], field).numpy(),
                                   np.asarray(getattr(ref['params'], field)),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize('name', sorted(GOLDENS))
def test_torch_dataset_loss_trajectory(name):
    """The reference's 30-epoch trajectory on the CPU, as
    tests/test_golden_parity.py holds the JAX package (the chip smoke run
    checks the same on the card)."""
    (tx, ty, vx, vy), ps, _ = load_dataset(name)
    g, w = _golden(name)
    res = api.train(tx, ty, vx, vy, ps,
                    ADMMConfig(epochs=len(g['train_loss']) - 1,
                               hidden_size=int(g['hidden'])),
                    params=params_from_dict(w), log_every=0, device='cpu')
    np.testing.assert_allclose(res['train_loss'], g['train_loss'], rtol=0.05,
                               atol=1e-4)
    np.testing.assert_allclose(res['val_loss'], g['val_loss'], rtol=0.05,
                               atol=1e-4)
    assert res['train_loss'][-1] <= g['train_loss'][-1] * 1.05


@pytest.mark.parametrize('name,o', [('SMSSpam', 2), ('GEFCOM2012Wind', 1)])
def test_torch_dataset_wide_and_two_outputs_match_jax(name, o):
    """SMSSpam (I = 95, O = 2) and GEFCOM2012Wind, cut to 256 samples, two
    epochs from numpy-seeded weights, against the JAX package."""
    (tx, ty, vx, vy), ps, _ = load_dataset(name, 256, 64)
    assert ty.shape[1] == o
    rng = np.random.default_rng(1)
    i = tx.shape[2]
    w = {f'x2{g}': (rng.standard_normal((i, 10)) * 0.3).astype(np.float32)
         for g in 'ifgo'}
    w.update({f'h2{g}': (rng.standard_normal((10, 10)) * 0.3)
              .astype(np.float32) for g in 'ifgo'})
    w['wy'] = (rng.standard_normal((10, o)) * 0.3).astype(np.float32)
    cfg = dict(epochs=2, hidden_size=10)
    ref = j_api.train(tx, ty, vx, vy, ps, JConfig(**cfg),
                      params=j_params_from_dict(w), log_every=0)
    got = api.train(tx, ty, vx, vy, ps, ADMMConfig(**cfg),
                    params=params_from_dict(w), log_every=0, device='cpu')
    np.testing.assert_allclose(got['train_loss'], ref['train_loss'],
                               rtol=1e-4)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=1e-4)
