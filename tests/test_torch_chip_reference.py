"""The JAX package's reference numbers that chip_smoke.py holds the card
to, recomputed with the JAX package on the CPU.  The chip machine has no
JAX, so chip_smoke.py carries them as constants; this test keeps those
constants equal to what the JAX package computes."""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu import api as j_api
from admm_lstm_tpu import tune as j_tune
from admm_lstm_tpu.core.init import init_admm_state
from admm_lstm_tpu.core.step import make_admm_step
from admm_lstm_tpu.data import load_dataset
from admm_lstm_tpu.models.lstm import params_from_dict

# f32 on another CPU may round a few last bits differently.
RTOL = 1e-5


@pytest.fixture(scope='module')
def googlestock():
    g = np.load(chip_smoke.GOLDEN)
    weights = {k[3:]: g[k] for k in g.files if k.startswith('w0_')}
    (tx, ty, vx, vy), ps, _ = load_dataset('GoogleStock')
    return tx, ty, vx, vy, ps, weights


def _train(data, cfg, **kw):
    tx, ty, vx, vy, ps, weights = data
    return j_api.train(tx, ty, vx, vy, ps, cfg,
                       params=params_from_dict(weights), log_every=0, **kw)


def test_torch_chip_reference_auto_trajectory_and_rho(googlestock):
    cfg = JConfig.auto(epochs=chip_smoke.EPOCHS, hidden_size=10,
                       matmul_precision='highest')
    res = _train(googlestock, cfg)
    np.testing.assert_allclose(res['train_loss'], chip_smoke.AUTO_TRAIN,
                               rtol=RTOL)
    np.testing.assert_allclose(res['val_loss'], chip_smoke.AUTO_VAL,
                               rtol=RTOL)
    tx, ty, _, _, ps, weights = googlestock
    state = init_admm_state(params_from_dict(weights), jnp.asarray(tx), ps,
                            cfg)
    step = make_admm_step(cfg, donate=False)
    for epoch in range(1, chip_smoke.EPOCHS + 1):
        state = step(state, jnp.asarray(tx), jnp.asarray(ty))
        for k in 'ifgochy':
            n = chip_smoke.AUTO_RHO_DOUBLINGS.get(k, [0] * 31)[epoch]
            got = float(getattr(state.rho, k))
            assert math.isclose(got, float(np.float32(ps.rho[k])) * 2.0 ** n,
                                rel_tol=1e-6), (epoch, k, got)


def test_torch_chip_reference_preset_vals(googlestock):
    epochs = chip_smoke.EPOCHS
    auto = _train(googlestock, JConfig.auto(epochs=epochs, hidden_size=10))
    np.testing.assert_allclose(auto['val_loss'][-1], chip_smoke.AUTO_VAL_30,
                               rtol=RTOL)
    turbo = _train(googlestock, JConfig.turbo(epochs=epochs, hidden_size=10))
    np.testing.assert_allclose(turbo['val_loss'][-1],
                               chip_smoke.TURBO_VAL_30, rtol=RTOL)
    best = _train(googlestock, JConfig(epochs=epochs, hidden_size=10),
                  preset='best')
    assert best['preset_choice'] == chip_smoke.BEST_CHOICE
    for k, v in chip_smoke.BEST_PROBE_VAL.items():
        np.testing.assert_allclose(best['probe_val'][k], v, rtol=RTOL)


def test_torch_chip_reference_tune_grid(googlestock):
    """search_rho's 27 validation losses on GoogleStock and the best rho
    (about a minute on the CPU)."""
    tx, ty, vx, vy, ps, weights = googlestock
    res = j_tune.search_rho(tx, ty, vx, vy, ps, JConfig(hidden_size=10),
                            epochs=chip_smoke.EPOCHS,
                            params=params_from_dict(weights))
    np.testing.assert_allclose(res['val_losses'], chip_smoke.TUNE_VAL,
                               rtol=RTOL)
    assert res['best_rho'] == chip_smoke.TUNE_BEST_RHO


@pytest.mark.parametrize('name', sorted(chip_smoke.DATASET_REF))
def test_torch_chip_reference_dataset_losses(name):
    """The default config's DATASET_EPOCHS-epoch trajectories on SMSSpam
    and GEFCOM2012Wind from chip_smoke.numpy_weights."""
    (tx, ty, vx, vy), ps, _ = load_dataset(name)
    weights = chip_smoke.numpy_weights(tx.shape[2], 10, ty.shape[1], 0)
    res = j_api.train(tx, ty, vx, vy, ps,
                      JConfig(epochs=chip_smoke.DATASET_EPOCHS,
                              hidden_size=10),
                      params=params_from_dict(weights), log_every=0)
    ref = chip_smoke.DATASET_REF[name]
    np.testing.assert_allclose(res['train_loss'], ref['train'], rtol=RTOL)
    np.testing.assert_allclose(res['val_loss'], ref['val'], rtol=RTOL)


def test_torch_chip_smoke_needs_a_card():
    """Without a CUDA card the script exits non-zero and prints no result
    line."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(chip_smoke.__file__))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
