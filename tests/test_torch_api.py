"""The port's training API and CLI against the JAX package's, on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from admm_lstm_tpu import api as j_api
from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu.models.lstm import params_from_dict as j_params_from_dict
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_torch import api
from admm_lstm_torch.data import load_dataset
from admm_lstm_torch.models.lstm import params_from_dict
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.device import NoCudaDeviceError

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'googlestock_fast.npz')


def _golden_weights():
    g = np.load(GOLDEN)
    return {k[3:]: g[k] for k in g.files if k.startswith('w0_')}


def test_torch_train_googlestock_matches_jax_train():
    """Full GoogleStock arrays, H=10, 3 epochs, golden seed-0 weights."""
    (tx, ty, vx, vy), _, _ = load_dataset('GoogleStock')
    w = _golden_weights()
    ref = j_api.train(tx, ty, vx, vy, j_parameter_set('GoogleStock'),
                      JConfig(epochs=3), params=j_params_from_dict(w),
                      log_every=0)
    got = api.train(tx, ty, vx, vy, parameter_set('GoogleStock'),
                    ADMMConfig(epochs=3), params=params_from_dict(w),
                    log_every=0, device='cpu')
    np.testing.assert_allclose(got['train_loss'], ref['train_loss'],
                               rtol=1e-4)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=1e-4)
    assert got['name'] == ref['name']
    assert got['state'].epoch == 3


def _synthetic_weights(hidden=5, seed=4):
    rng = np.random.default_rng(seed)
    w = {f'x2{g}': (rng.standard_normal((1, hidden)) * 0.5).astype(np.float32)
         for g in 'ifgo'}
    w.update({f'h2{g}': (rng.standard_normal((hidden, hidden)) * 0.4)
              .astype(np.float32) for g in 'ifgo'})
    w['wy'] = (rng.standard_normal((hidden, 1)) * 0.5).astype(np.float32)
    return w


@pytest.mark.parametrize('kw', [
    dict(track_best=True),
    dict(stop_tol=0.5),
    dict(stop_divergence=1.0001, track_best=True),
])
def test_torch_train_stopping_and_best_match_jax(kw):
    (tx, ty, vx, vy), _, _ = load_dataset('Synthetic', batch=64, seq_len=5,
                                          val_batch=16)
    w = _synthetic_weights()
    cfg = dict(epochs=8, hidden_size=5)
    ref = j_api.train(tx, ty, vx, vy, j_parameter_set('Synthetic'),
                      JConfig(**cfg), params=j_params_from_dict(w),
                      log_every=0, **kw)
    got = api.train(tx, ty, vx, vy, parameter_set('Synthetic'),
                    ADMMConfig(**cfg), params=params_from_dict(w),
                    log_every=0, device='cpu', **kw)
    assert len(got['val_loss']) == len(ref['val_loss'])
    assert got['best_epoch'] == ref['best_epoch']
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=1e-4)
    assert len(got['residuals']) == len(ref['residuals'])
    for a, b in zip(got['residuals'], ref['residuals']):
        assert set(a) == set(b)
        np.testing.assert_allclose([a[k] for k in sorted(a)],
                                   [b[k] for k in sorted(b)],
                                   rtol=1e-3, atol=1e-7)
    for field in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(getattr(got['params'], field).numpy(),
                                   np.asarray(getattr(ref['params'], field)),
                                   atol=1e-4)


def test_torch_optimizer_object_matches_jax():
    """ADMMBasedOptimizer: the reference's optimizer.step() contract."""
    (tx, ty, _, _), _, _ = load_dataset('Synthetic', batch=40, seq_len=4,
                                        val_batch=4)
    w = _synthetic_weights()
    ref = j_api.ADMMBasedOptimizer(j_params_from_dict(w), (tx, ty),
                                   j_parameter_set('Synthetic'),
                                   JConfig(hidden_size=5))
    got = api.ADMMBasedOptimizer(params_from_dict(w), (tx, ty),
                                 parameter_set('Synthetic').as_dict(),
                                 ADMMConfig(hidden_size=5), device='cpu')
    for _ in range(2):
        ref.step()
        got.step()
    for field in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(getattr(got.params, field).numpy(),
                                   np.asarray(getattr(ref.params, field)),
                                   atol=1e-5)
    ref_res, got_res = ref.residuals(), got.residuals()
    assert set(got_res) == set(ref_res)
    for k in ref_res:
        np.testing.assert_allclose(float(got_res[k]), float(ref_res[k]),
                                   rtol=1e-3, atol=1e-7, err_msg=k)


def test_torch_train_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    (tx, ty, vx, vy), ps, _ = load_dataset('Synthetic', batch=8, val_batch=4)
    with pytest.raises(NoCudaDeviceError):
        api.train(tx, ty, vx, vy, ps, ADMMConfig(epochs=1))


@pytest.mark.parametrize('kw', [dict(checkpoint_dir='ckpt'),
                                dict(resume_from='ckpt')])
def test_torch_train_unported_options_raise(kw, tmp_path):
    """The checkpoint options run now (a resume from an empty directory
    starts from scratch, as in the JAX package); train_sharded still
    raises."""
    (tx, ty, vx, vy), ps, _ = load_dataset('Synthetic', batch=8, val_batch=4)
    kw = {k: str(tmp_path / v) for k, v in kw.items()}
    res = api.train(tx, ty, vx, vy, ps, ADMMConfig(epochs=2), device='cpu',
                    checkpoint_every=1, log_every=0, **kw)
    assert res['state'].epoch == 2 and len(res['train_loss']) == 3
    saved = sorted(os.listdir(tmp_path / 'ckpt'))
    assert saved == (['step_1.pt', 'step_2.pt'] if 'checkpoint_dir' in kw
                     else [])
    with pytest.raises(NotImplementedError, match='train_sharded'):
        api.train_sharded(tx, ty, vx, vy, ps, ADMMConfig(epochs=1))


@pytest.mark.parametrize('cfgkw', [dict(epochs=8), dict(epochs=40)],
                         ids=['probe8', 'probe15'])
def test_torch_train_preset_best_matches_jax(cfgkw):
    """preset='best' on small Synthetic data: the same choice, probe
    losses at rtol 1e-4 and the committed trajectory at rtol 1e-4 (f32,
    summation order).  40 epochs probe for the 15-epoch floor."""
    (tx, ty, vx, vy), _, _ = load_dataset('Synthetic', batch=64, seq_len=5,
                                          val_batch=16)
    w = _synthetic_weights()
    cfg = dict(cfgkw, hidden_size=5)
    ref = j_api.train(tx, ty, vx, vy, j_parameter_set('Synthetic'),
                      JConfig(**cfg), params=j_params_from_dict(w),
                      log_every=0, preset='best')
    got = api.train(tx, ty, vx, vy, parameter_set('Synthetic'),
                    ADMMConfig(**cfg), params=params_from_dict(w),
                    log_every=0, preset='best', device='cpu')
    assert got['preset_choice'] == ref['preset_choice']
    assert set(got['probe_val']) == {'shipped', 'auto'}
    for k, v in ref['probe_val'].items():
        np.testing.assert_allclose(got['probe_val'][k], v, rtol=1e-4)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=1e-4)
    assert got['best_epoch'] == ref['best_epoch']


def test_torch_train_best_unported_legs_raise():
    """The legacy variants' candidate sets still raise, and resume_from
    stays refused (train_best(search_rounds > 0) runs now:
    tests/test_torch_tune.py)."""
    (tx, ty, vx, vy), ps, _ = load_dataset('Synthetic', batch=8, val_batch=4)
    with pytest.raises(NotImplementedError, match='admm_l'):
        api.train_best(tx, ty, vx, vy, ps, ADMMConfig(variant='admm_l',
                                                      epochs=1),
                       device='cpu')
    with pytest.raises(ValueError, match='resume_from'):
        api.train_best(tx, ty, vx, vy, ps, ADMMConfig(epochs=1),
                       resume_from='ckpt', device='cpu')
    with pytest.raises(ValueError, match='preset'):
        api.train(tx, ty, vx, vy, ps, ADMMConfig(epochs=1), preset='fast',
                  device='cpu')
    assert api.derive_auto_config(ADMMConfig(hidden_size=7, epochs=3)) == \
        ADMMConfig.auto(hidden_size=7, epochs=3)


@pytest.mark.parametrize('start', [(False, True), (True, False)])
def test_torch_train_restores_tf32_flags(start):
    """A turbo() run (matmul_precision='default' turns TF32 on) and a
    default run leave the process-wide TF32 flags as they found them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    (tx, ty, vx, vy), ps, _ = load_dataset('Synthetic', batch=16, seq_len=4,
                                          val_batch=4)
    try:
        for cfg in (ADMMConfig.turbo(epochs=1, hidden_size=3),
                    ADMMConfig(epochs=1, hidden_size=3)):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = start
            api.train(tx, ty, vx, vy, ps, cfg, log_every=0, device='cpu')
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == start
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _cli(args, tmp_path):
    env = dict(os.environ, ADMM_TORCH_NO_FILELOG='1', PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, '-m', 'admm_lstm_torch.cli', *args],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)


def test_torch_cli_cpu_run(tmp_path):
    proc = _cli(['--cpu', '-y', '-d', 'GoogleStock', '-e', '2', '--hidden',
                 '10', '--no-plot'], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'Epoch 2 has done' in proc.stdout


def test_torch_cli_without_card_or_cpu_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    proc = _cli(['-y', '-e', '1', '--no-plot'], tmp_path)
    assert proc.returncode != 0
    assert 'no CUDA device was found' in proc.stdout


@pytest.mark.parametrize('flag', [['--mesh', '2'], ['--layers', '2'],
                                  ['--variant', 'admm_l']])
def test_torch_cli_later_slice_flags_fail(flag):
    from admm_lstm_torch.cli import main
    assert main(['--cpu', '-y', '-e', '1', '--no-plot', *flag]) != 0


@pytest.mark.parametrize('flag', [['--turbo'], ['--preset', 'best'],
                                  ['--exact_weight_solve']])
def test_torch_cli_turbo_leg_flags_run(flag):
    from admm_lstm_torch.cli import main
    assert main(['--cpu', '-y', '-e', '2', '--no-plot', '-d', 'Synthetic',
                 *flag]) == 0


def test_torch_cli_dna1_run(tmp_path):
    proc = _cli(['--cpu', '-y', '-d', 'DNA1', '-e', '2', '--no-plot'],
                tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'Epoch 2 has done' in proc.stdout


def test_torch_cli_tune_rho_run():
    from admm_lstm_torch.cli import main
    assert main(['--cpu', '-y', '-d', 'Synthetic', '-nt', '64', '-nv', '16',
                 '-e', '2', '--hidden', '4', '--no-plot',
                 '--tune_rho', '1']) == 0


def test_torch_cli_checkpoint_then_resume(tmp_path):
    from admm_lstm_torch.cli import main
    ckpt = str(tmp_path / 'ckpt')
    args = ['--cpu', '-y', '-d', 'Synthetic', '-nt', '64', '-nv', '16',
            '--hidden', '4', '--no-plot', '--checkpoint_dir', ckpt,
            '--checkpoint_every', '1']
    assert main([*args, '-e', '2']) == 0
    assert sorted(os.listdir(ckpt)) == ['step_1.pt', 'step_2.pt']
    assert main([*args, '-e', '3', '--resume']) == 0
    assert sorted(os.listdir(ckpt)) == ['step_1.pt', 'step_2.pt', 'step_3.pt']
    assert main(['--cpu', '-y', '-e', '1', '--no-plot', '--resume']) != 0


def test_torch_cli_data_dir(tmp_path):
    """--data_dir reaches the HAR loader (files the test writes) and is
    refused for a bundled dataset, as in the JAX CLI."""
    from admm_lstm_torch.cli import main
    labels = [1] * 12 + [2] * 11 + [3] * 20
    feats = np.random.default_rng(0).standard_normal((len(labels), 6))
    for split in ('train', 'test'):
        np.savetxt(tmp_path / f'X_{split}.txt', feats)
        np.savetxt(tmp_path / f'y_{split}.txt', labels, fmt='%d')
    args = ['--cpu', '-y', '-e', '1', '--hidden', '3', '--no-plot',
            '--data_dir', str(tmp_path)]
    assert main([*args, '-d', 'HAR']) == 0
    assert main([*args, '-d', 'GoogleStock']) != 0


def test_torch_cli_auto_run(tmp_path):
    proc = _cli(['--cpu', '-y', '-d', 'GoogleStock', '-e', '2', '--hidden',
                 '10', '--no-plot', '--auto'], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'Epoch 2 has done' in proc.stdout


@pytest.mark.slow
def test_torch_googlestock_loss_trajectory():
    """The 30-epoch reference trajectory on the CPU (the chip smoke run
    checks the same on the card)."""
    g = np.load(GOLDEN)
    res = api.train(g['train_x'], g['train_y'], g['test_x'], g['test_y'],
                    parameter_set('GoogleStock'), ADMMConfig(epochs=30),
                    params=params_from_dict(_golden_weights()), log_every=0,
                    device='cpu')
    np.testing.assert_allclose(res['train_loss'], g['train_loss'][:31],
                               rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(res['val_loss'], g['val_loss'][:31],
                               rtol=0.05, atol=1e-4)
    assert res['val_loss'][-1] <= 0.346877 * 1.05
