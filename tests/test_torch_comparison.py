"""The port's comparison harness (admm_lstm_torch/comparison.py), its
ADMM-LSTM-S cache reader, plot_comparison, the legacy variants'
`train_best` and their CLI, on the CPU.  The legacy preset is held to the
JAX package's `train_best` on its seeded synthetic problems."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu import api as j_api
from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.models.lstm import init_lstm_params
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_torch import api, comparison
from admm_lstm_torch.data.admm_s_cache import load_admm_s_cache
from admm_lstm_torch.models.lstm import params_from_numpy
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.device import NoCudaDeviceError
from admm_lstm_torch.variants.admm_l import admm_l_demo
from admm_lstm_torch.variants.admm_s import admm_s_demo
from admm_lstm_torch.variants.grad_based import train_grad_based

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ['Fast ADMM-LSTM', 'ADMM-LSTM-L', 'ADMM-LSTM-S', 'SGD', 'Adam',
         'Adagrad']


@pytest.fixture(scope='module')
def small():
    data = synth(batch=32, seq_len=4, input_size=1, output_size=1,
                 val_batch=8)
    jp = init_lstm_params(jax.random.PRNGKey(0), 1, 4, 1)
    return data, params_from_numpy(*(np.array(w) for w in jp))


def test_torch_run_comparison_curves_equal_standalone_runs(small):
    """Six results in the reference's order; each curve is its method's
    run alone from the same weights (every method trains its own copy)."""
    (tx, ty, vx, vy), params = small
    ps = parameter_set('Synthetic')
    before = [w.clone() for w in params]
    results = comparison.run_comparison(
        2, 4, tx, ty, vx, vy, ps, include_admm_l=True, include_admm_s=True,
        params=params, device='cpu')
    assert [r['name'] for r in results] == NAMES
    alone = [
        api.train(tx, ty, vx, vy, ps, ADMMConfig(epochs=2, hidden_size=4),
                  params=params, log_every=0, device='cpu'),
        admm_l_demo(2, 4, tx, ty, vx, vy, log_every=0, device='cpu'),
        admm_s_demo(2, 4, tx, ty, vx, vy, log_every=0, device='cpu')]
    alone += [train_grad_based(m, tx, ty, vx, vy, 2, params=params,
                               device='cpu')
              for m in ('sgd', 'adam', 'adagrad')]
    for got, want in zip(results, alone):
        assert got['name'] == want['name']
        assert len(got['train_loss']) == 3
        assert got['train_loss'] == want['train_loss'], got['name']
        assert got['val_loss'] == want['val_loss'], got['name']
    for a, b in zip(params, before):
        assert torch.equal(a, b)


def test_torch_run_comparison_consumes_cache_path(small, tmp_path):
    """A recorded ADMM-LSTM-S trajectory in the pair format, truncated to
    num_epochs + 1 (tests/test_interop.py's JAX counterpart)."""
    (tx, ty, vx, vy), params = small
    p = tmp_path / 'ADMM-LSTM.Synthetic'
    p.write_text('\n'.join(f'{5.0 / (i + 1)} {4.5 / (i + 1)}'
                           for i in range(11)) + '\n')
    results = comparison.run_comparison(
        3, 4, tx, ty, vx, vy, parameter_set('Synthetic'),
        include_admm_l=False, admm_s_cached=str(p), skip_fast=True,
        params=params, device='cpu')
    names = [r['name'] for r in results]
    assert names == ['ADMM-LSTM-S', 'SGD', 'Adam', 'Adagrad']
    assert results[0]['train_loss'] == [5.0, 2.5, 5.0 / 3, 1.25]


def test_torch_admm_s_cache_results_py_format(tmp_path):
    p = tmp_path / 'results.py'
    p.write_text('# recorded\nadmm_s_loss = {\n  "name": "ADMM-LSTM-S",\n'
                 '  "train_loss": [5.0, 3.0, 1.0],\n'
                 '  "val_loss": [4.5, 3.2, 1.2],\n}\n')
    out = load_admm_s_cache(str(p))
    assert out == {'name': 'ADMM-LSTM-S', 'train_loss': [5.0, 3.0, 1.0],
                   'val_loss': [4.5, 3.2, 1.2]}


def test_torch_admm_s_cache_pair_format(tmp_path):
    p = tmp_path / 'ADMM-LSTM.Synthetic'
    p.write_text('5.0 4.5\n3.0 3.2\n\n1.0 1.2\n')
    out = load_admm_s_cache(str(p))
    assert out['train_loss'] == [5.0, 3.0, 1.0]
    assert out['val_loss'] == [4.5, 3.2, 1.2]
    bad = tmp_path / 'bad'
    bad.write_text('1.0 2.0 3.0\n')
    with pytest.raises(ValueError):
        load_admm_s_cache(str(bad))


def test_torch_export_matlab_round_trip(tmp_path):
    import scipy.io as sio
    results = [{'name': n, 'val_loss': [1.0 / (k + 1), 0.5, 0.25 + k]}
               for k, n in enumerate(NAMES)]
    path = comparison.export_matlab(results, save_dir=str(tmp_path))
    data = sio.loadmat(path)
    for k, n in enumerate(NAMES):
        key = re.sub('[ -]', '', n)
        np.testing.assert_array_equal(data[key].ravel(),
                                      results[k]['val_loss'])


def test_torch_plot_comparison_writes_files(tmp_path):
    pytest.importorskip('matplotlib')
    from admm_lstm_torch.utils.plotting import plot_comparison
    results = [{'name': n, 'train_loss': [3.0, 2.0, 1.0],
                'val_loss': [3.5, 2.5, 1.5]} for n in NAMES]
    paths = plot_comparison(results, 2, save_dir=str(tmp_path))
    assert [os.path.basename(p) for p in paths] == [
        'ComparisonTrainingLoss.png', 'ComparisonValidationLoss.png']
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_torch_run_comparison_needs_the_card_unless_asked(small):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    (tx, ty, vx, vy), _ = small
    with pytest.raises(NoCudaDeviceError):
        comparison.run_comparison(1, 4, tx, ty, vx, vy,
                                  parameter_set('Synthetic'))


# The legacy preset on synthetic problems where JAX's choice wins by a
# clear margin (ADMM-L: rho11_1e-3 by 3%; ADMM-S: r_h_10 by 9%).  ADMM-S
# at r_h = 10 is unstable on this problem: a 1e-7 difference in rounding
# grows about tenfold every 4 epochs past epoch 10, so its probe (the
# trajectory's minimum, at epoch 30) is held at R_H_10_RTOL; every other
# probe at PROBE_RTOL.
PROBE_RTOL = 1e-5
R_H_10_RTOL = 1e-3
LEGACY = {
    'admm_l': (dict(batch=48, seq_len=5, input_size=1, val_batch=16),
               dict(hidden_size=4, epochs=12), 6),
    'admm_s': (dict(batch=64, seq_len=6, input_size=1, val_batch=16,
                    seed=1), dict(hidden_size=6, epochs=30), 30),
}


@pytest.mark.parametrize('variant', list(LEGACY))
def test_torch_train_best_legacy_makes_jax_choice(variant):
    data_kw, cfg_kw, probe = LEGACY[variant]
    tx, ty, vx, vy = synth(output_size=1, **data_kw)
    want = j_api.train_best(tx, ty, vx, vy, j_parameter_set('Synthetic'),
                            JConfig(variant=variant, **cfg_kw),
                            probe_epochs=probe, log_every=0)
    got = api.train_best(tx, ty, vx, vy, parameter_set('Synthetic'),
                         ADMMConfig(variant=variant, **cfg_kw),
                         probe_epochs=probe, log_every=0, device='cpu')
    assert got['preset_choice'] == want['preset_choice']
    assert got['probe_val'].keys() == want['probe_val'].keys()
    for k, v in want['probe_val'].items():
        rtol = R_H_10_RTOL if k == 'r_h_10' else PROBE_RTOL
        np.testing.assert_allclose(got['probe_val'][k], v, rtol=rtol,
                                   err_msg=k)
    assert len(got['val_loss']) == cfg_kw['epochs'] + 1


@pytest.mark.parametrize('kw', [dict(checkpoint_dir='ckpt'),
                                dict(resume_from='ckpt')])
def test_torch_train_best_legacy_refuses_checkpoints(kw):
    tx, ty, vx, vy = synth(batch=8, seq_len=3, input_size=1, output_size=1,
                           val_batch=4)
    with pytest.raises(ValueError, match='checkpoint'):
        api.train_best(tx, ty, vx, vy, parameter_set('Synthetic'),
                       ADMMConfig(variant='admm_l', epochs=1), device='cpu',
                       **kw)


def _run(module, args, tmp_path):
    # One thread, as the test process: under xdist, a subprocess with a
    # thread per core competes with every worker.
    env = dict(os.environ, ADMM_TORCH_NO_FILELOG='1', PYTHONPATH=ROOT,
               OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', module, *args],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize('variant,extra', [('admm_l', []), ('admm_s', []),
                                           ('admm_l', ['--preset', 'best'])],
                         ids=['admm_l', 'admm_s', 'admm_l-preset'])
def test_torch_cli_legacy_variants(variant, extra, tmp_path):
    proc = _run('admm_lstm_torch.cli',
                ['--cpu', '-y', '-d', 'GoogleStock', '-e', '2', '--no-plot',
                 '--variant', variant, *extra], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    if variant == 'admm_l':
        train = [float(v) for v in re.findall(r'loss train = ([0-9.e-]+)',
                                              proc.stdout)]
    else:
        train = [float(v) for v in re.findall(r'loss_train: ([0-9.]+)',
                                              proc.stdout)]
    assert len(train) >= 2 and np.all(np.isfinite(train)), proc.stdout
    assert train[-1] < train[0], proc.stdout
    if extra:
        assert "preset='best' [admm_l]" in proc.stdout


def test_torch_comparison_cli(tmp_path):
    proc = _run('admm_lstm_torch.comparison',
                ['--cpu', '-e', '2', '--record_matlab_data'], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    finals = re.findall(r'INFO\S*: (.+?): final train ([0-9.]+) \| val '
                        r'([0-9.]+)', proc.stdout)
    assert [n for n, _, _ in finals] == [
        'Fast ADMM-LSTM', 'ADMM-LSTM-L', 'SGD', 'Adam', 'Adagrad']
    assert all(np.isfinite(float(v)) for _, a, b in finals for v in (a, b))
    assert (tmp_path / 'MATLAB_VAL_DATA' / 'MATLAB_Val_comparison.mat'
            ).is_file()


def test_torch_comparison_cli_without_card_or_cpu_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    proc = _run('admm_lstm_torch.comparison', ['-e', '1', '--no-plot'],
                tmp_path)
    assert proc.returncode != 0
    assert 'no CUDA device was found' in proc.stdout


@pytest.mark.parametrize('variant', ['admm_l', 'admm_s', 'sgd', 'adam',
                                     'adagrad'])
def test_torch_profile_epoch_legacy_epochs_run(variant):
    """profile_epoch.py --variant's epochs (the profiling itself needs the
    card) step their state with finite weights."""
    from admm_lstm_torch.profile_epoch import legacy_epoch
    tx, ty, vx, vy = (torch.from_numpy(a) for a in synth(
        batch=16, seq_len=4, input_size=1, output_size=1, val_batch=4))
    epoch, state = legacy_epoch(variant, 3, tx, ty, vx, vy)
    for _ in range(2):
        state = epoch(state)
    if state is not None:
        assert state.epoch == 2
        assert all(bool(torch.isfinite(t).all()) for t in state[:-1])
