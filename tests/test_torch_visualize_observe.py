"""The port's visualize.py, utils/observe.py, the prediction plot and the
runtime helpers of utils/logging.py, against the JAX package's on the CPU
(tests/test_cli.py and tests/test_observe.py hold the JAX ones)."""

import os
import time

import jax
import numpy as np
import pytest
import torch

from admm_lstm_tpu import visualize as j_visualize
from admm_lstm_tpu.ckpt import save_model as j_save_model
from admm_lstm_tpu.models.lstm import init_lstm_params as j_init_params
from admm_lstm_tpu.variants.stacked import init_stacked as j_init_stacked
from admm_lstm_torch import visualize
from admm_lstm_torch.ckpt import save_model
from admm_lstm_torch.models.lstm import params_from_numpy
from admm_lstm_torch.utils import plotting
from admm_lstm_torch.utils.observe import (ThroughputMeter, annotate,
                                           profile_trace)

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')


def _numpy_params(seed, hidden=4):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((4, 1, hidden)) * 0.5).astype(np.float32),
            (rng.standard_normal((4, hidden, hidden)) * 0.4).astype(
                np.float32),
            (rng.standard_normal((hidden, 1)) * 0.5).astype(np.float32))


@pytest.fixture
def saved_models(tmp_path, monkeypatch):
    """SAVED_MODELS/ in a temporary working directory with one model
    saved by each package."""
    monkeypatch.chdir(tmp_path)
    j_save_model('from-jax', j_init_params(jax.random.PRNGKey(3), 1, 4, 1),
                 save_dir='SAVED_MODELS')
    save_model('from torch [fast] scenario 0',
               params_from_numpy(*_numpy_params(5)), save_dir='SAVED_MODELS')
    return tmp_path / 'SAVED_MODELS'


def test_torch_visualize_matches_jax(saved_models):
    x = np.random.default_rng(0).standard_normal((7, 6, 1)).astype(
        np.float32)
    want = j_visualize.predict_all(j_visualize.load_models(str(saved_models)),
                                   x)
    models = visualize.load_models(str(saved_models), device='cpu')
    assert set(models) == set(want) == {'from-jax',
                                        'from torch [fast] scenario 0'}
    got = visualize.predict_all(models, x)
    for name in want:
        assert got[name].shape == (7, 1)
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   err_msg=name)
    path = visualize.plot_all(got, np.zeros((7, 1)))
    assert path == os.path.join('plots', 'Predictions.png')
    assert os.path.isfile(path)


def test_torch_visualize_main_on_cpu(saved_models):
    assert visualize.main(['-d', 'Synthetic', '--cpu']) == 0
    assert os.path.isfile(os.path.join('plots', 'Predictions.png'))


def test_torch_visualize_main_without_models_or_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert visualize.main(['-d', 'Synthetic', '--cpu']) == 1
    if not torch.cuda.is_available():
        assert visualize.main(['-d', 'Synthetic']) == 1


def test_torch_visualize_stacked_file_fails_as_in_jax(saved_models):
    """A stacked model's file loads, and the one-layer forward refuses it
    in both packages (no stacked forward in visualize)."""
    j_save_model('stacked', j_init_stacked(jax.random.PRNGKey(0), 1, (4, 4),
                                           1), save_dir='SAVED_MODELS')
    x = np.zeros((3, 5, 1), np.float32)
    with pytest.raises((AttributeError, TypeError)):
        j_visualize.predict_all(j_visualize.load_models(str(saved_models)), x)
    with pytest.raises((AttributeError, TypeError)):
        visualize.predict_all(visualize.load_models(str(saved_models),
                                                    device='cpu'), x)


def test_torch_plot_predictions_without_matplotlib(saved_models,
                                                   monkeypatch):
    """Without matplotlib the prediction plot raises ImportError naming
    --no-plot, as the other plotters do; visualize exits 1 on it."""
    def missing():
        raise ImportError('plotting needs matplotlib; rerun with --no-plot')
    monkeypatch.setattr(plotting, '_pyplot', missing)
    truth = np.sin(np.linspace(0, 6, 50))
    with pytest.raises(ImportError, match='--no-plot'):
        plotting.plot_predictions({'a': truth + 0.1}, truth)
    assert visualize.main(['-d', 'Synthetic', '--cpu']) == 1
    assert not os.path.exists(os.path.join('plots', 'Predictions.png'))


def test_torch_visualize_no_plot(saved_models, capsys):
    """--no-plot predicts with every model and logs its test MSE, with
    no figure."""
    from admm_lstm_torch.data import load_dataset
    assert visualize.main(['-d', 'Synthetic', '--cpu', '--no-plot']) == 0
    assert not os.path.exists('plots')
    (_, _, test_x, test_y), _, _ = load_dataset('Synthetic')
    preds = visualize.predict_all(
        visualize.load_models(str(saved_models), device='cpu'), test_x)
    out = capsys.readouterr().out
    for name, pred in preds.items():
        assert f'{name}: test MSE ' in out
        mse = float(np.mean((pred - test_y) ** 2))
        assert f'{mse:.8f}' in out


def test_torch_throughput_meter():
    meter = ThroughputMeter(window=10)
    for _ in range(5):
        meter.update()
        time.sleep(0.001)
    assert meter.total == 5
    assert meter.iters_per_s > 0
    meter.report('test ')


def test_torch_profile_trace_noop(tmp_path):
    with profile_trace(None):
        pass
    assert not any(os.scandir(tmp_path))


def test_torch_profile_trace_capture(tmp_path):
    with profile_trace(str(tmp_path)):
        with annotate('test-region'):
            torch.ones(8).sum()
    (entry,) = os.scandir(tmp_path)
    assert entry.name.endswith('.json')
    with open(entry.path) as f:
        assert 'test-region' in f.read()


def test_torch_runtime_util_parity():
    """The reference's _global.py runtime utilities: the decorators, the
    probes and the key/value store."""
    from admm_lstm_torch.utils.logging import (GlobalDict, callback,
                                               current_memory_usage,
                                               deprecated,
                                               device_memory_stats,
                                               total_memory)

    @deprecated('old thing')
    def legacy(a):
        return a + 1

    assert legacy(1) == 2

    calls = []

    @callback(calls.append, 'done')
    def work(a):
        return a * 2

    assert work(3) == 6
    assert calls == ['done']

    assert current_memory_usage() > 1024 ** 2      # at least 1 MB resident
    assert 0.5 < total_memory() < 100000           # plausible GB figure
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    if not torch.cuda.is_available():
        assert stats == {}

    store = GlobalDict()
    store['k'] = 3
    store.set('j', 4)
    assert store['k'] == 3 and store.get('j') == 4
    assert sorted(store.keys()) == ['j', 'k']
