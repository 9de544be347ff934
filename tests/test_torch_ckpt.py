"""Checkpoint/resume of the port (admm_lstm_torch.ckpt) on the CPU: the
full-state round trip, bit-equal resume, async saves, max_to_keep, and
.npz models passing between the two packages."""

import os

import jax
import numpy as np
import pytest
import torch

from admm_lstm_tpu.ckpt import load_model as j_load_model
from admm_lstm_tpu.ckpt import save_model as j_save_model
from admm_lstm_tpu.models.lstm import init_lstm_params as j_init_lstm_params
from admm_lstm_tpu.models.lstm import lstm_forward as j_lstm_forward
from admm_lstm_torch import api
from admm_lstm_torch.ckpt import CheckpointManager, load_model, save_model
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.step import make_admm_step
from admm_lstm_torch.data import load_dataset
from admm_lstm_torch.models.lstm import init_lstm_params, lstm_forward
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

GROUPS = ('params', 'gates', 'duals', 'rho', 'beta')


@pytest.fixture(scope='module')
def data():
    (tx, ty, vx, vy), _, _ = load_dataset('Synthetic', batch=32, seq_len=5,
                                          input_size=2, val_batch=8)
    return tx, ty, vx, vy


def _state(data, config, epochs=0):
    tx, ty, _, _ = data
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    params = init_lstm_params(torch.Generator().manual_seed(3), 2,
                              config.hidden_size, 1)
    state = init_admm_state(params, x, parameter_set('Synthetic'), config)
    step = make_admm_step(config)
    for _ in range(epochs):
        state = step(state, x, y)
    return state


def _assert_states_equal(a, b):
    assert a.epoch == b.epoch
    for group in GROUPS:
        for field, t in getattr(a, group)._asdict().items():
            u = getattr(getattr(b, group), field)
            assert t.dtype == u.dtype and t.shape == u.shape, (group, field)
            assert torch.equal(t, u), (group, field)


@pytest.mark.parametrize('cfgkw', [dict(hidden_size=4),
                                   dict(hidden_size=4, dtype='bfloat16'),
                                   dict(hidden_size=4, adaptive_rho=True)])
def test_torch_checkpoint_roundtrip(tmp_path, data, cfgkw):
    """Every leaf of the state, adapted rho and bf16 slabs included, and
    the epoch come back equal."""
    state = _state(data, ADMMConfig(**cfgkw), epochs=2)
    mgr = CheckpointManager(str(tmp_path / 'ckpt'))
    mgr.save(state)
    assert mgr.latest_step() == 2
    _assert_states_equal(mgr.restore(device='cpu'), state)
    mgr.close()


def test_torch_checkpoint_restore_without_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / 'empty'))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(device='cpu')


def test_torch_checkpoint_async_save_and_max_to_keep(tmp_path, data):
    """Async saves write after `save` returns; a later epoch does not reach
    an earlier save's file; only the newest max_to_keep steps stay."""
    cfg = ADMMConfig(hidden_size=4)
    tx, ty, _, _ = data
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    step = make_admm_step(cfg)
    mgr = CheckpointManager(str(tmp_path / 'ckpt'), max_to_keep=2,
                            async_save=True)
    state = _state(data, cfg)
    saved = {}
    for _ in range(4):
        state = step(state, x, y)
        mgr.save(state)
        saved[state.epoch] = state
    mgr.wait()
    assert sorted(os.listdir(mgr.directory)) == ['step_3.pt', 'step_4.pt']
    for s in (3, 4):
        _assert_states_equal(mgr.restore(step=s, device='cpu'), saved[s])
    mgr.close()


def test_torch_checkpoint_failed_background_write_raises(tmp_path, data):
    mgr = CheckpointManager(str(tmp_path / 'ckpt'), async_save=True)
    os.rmdir(mgr.directory)
    mgr.save(_state(data, ADMMConfig(hidden_size=4), epochs=1))
    with pytest.raises(RuntimeError, match='checkpoint write'):
        mgr.wait()


@pytest.mark.parametrize('async_checkpoint', [False, True])
def test_torch_train_resume_bit_equal_to_straight_run(tmp_path, data,
                                                      async_checkpoint):
    """train(resume_from=...) continues the trajectory exactly: the
    checkpointed run's losses, the resumed run's losses (starting at the
    resumed epoch) and the whole final state equal the straight run's bit
    for bit."""
    tx, ty, vx, vy = data
    ps = parameter_set('Synthetic')
    cfg = ADMMConfig(hidden_size=4)
    run = lambda epochs, **kw: api.train(
        tx, ty, vx, vy, ps, cfg.replace(epochs=epochs), log_every=0,
        device='cpu', **kw)
    full = run(6)
    ckpt = str(tmp_path / 'resume')
    first = run(3, checkpoint_dir=ckpt, checkpoint_every=3,
                async_checkpoint=async_checkpoint)
    resumed = run(6, resume_from=ckpt)
    assert first['train_loss'] == full['train_loss'][:4]
    assert resumed['train_loss'] == full['train_loss'][3:]
    assert resumed['val_loss'] == full['val_loss'][3:]
    _assert_states_equal(resumed['state'], full['state'])


def test_torch_train_checkpoints_every_and_resumes_in_place(tmp_path, data):
    """checkpoint_every bounds the chunks: a save at every multiple; a run
    that resumes from its own checkpoint directory goes on saving there."""
    tx, ty, vx, vy = data
    ps = parameter_set('Synthetic')
    cfg = ADMMConfig(hidden_size=4)
    ckpt = str(tmp_path / 'ckpt')
    api.train(tx, ty, vx, vy, ps, cfg.replace(epochs=4), log_every=3,
              checkpoint_dir=ckpt, checkpoint_every=2, device='cpu')
    assert sorted(os.listdir(ckpt)) == ['step_2.pt', 'step_4.pt']
    res = api.train(tx, ty, vx, vy, ps, cfg.replace(epochs=6), log_every=0,
                    checkpoint_dir=ckpt, checkpoint_every=2,
                    resume_from=ckpt, device='cpu')
    assert res['state'].epoch == 6 and len(res['train_loss']) == 3
    assert sorted(os.listdir(ckpt)) == ['step_2.pt', 'step_4.pt', 'step_6.pt']


def test_torch_model_npz_passes_between_packages(tmp_path):
    """A .npz the JAX package writes loads in the port and the reverse,
    with the same keys and the same predictions."""
    x = np.random.default_rng(0).standard_normal((6, 4, 3)).astype('float32')
    j_params = j_init_lstm_params(jax.random.PRNGKey(1), 3, 5, 2)
    j_path = j_save_model('from-jax', j_params, save_dir=str(tmp_path))
    got = load_model(j_path, device='cpu')
    np.testing.assert_array_equal(got.wx.numpy(), np.asarray(j_params.wx))
    np.testing.assert_array_equal(got.wh.numpy(), np.asarray(j_params.wh))
    np.testing.assert_array_equal(got.wy.numpy(), np.asarray(j_params.wy))

    params = init_lstm_params(torch.Generator().manual_seed(2), 3, 5, 2)
    path = save_model('from-torch', params, save_dir=str(tmp_path))
    with np.load(path) as a, np.load(j_path) as b:
        assert sorted(a.files) == sorted(b.files)
    loaded = j_load_model(path)
    np.testing.assert_array_equal(np.asarray(loaded.wx), params.wx.numpy())
    np.testing.assert_allclose(np.asarray(j_lstm_forward(loaded, x)),
                               lstm_forward(params, torch.from_numpy(x))
                               .numpy(), atol=1e-6)


def test_torch_load_model_of_stacked_file_raises(tmp_path):
    """A stacked file loads as StackedParams now
    (tests/test_torch_stacked.py); one missing a layer's block raises,
    naming the key."""
    path = str(tmp_path / 'stacked.npz')
    np.savez(path, l0_x2i=np.zeros((1, 2), np.float32),
             wy=np.zeros((2, 1), np.float32))
    with pytest.raises(KeyError, match='x2f'):
        load_model(path, device='cpu')
