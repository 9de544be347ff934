"""Data-parallel consensus ADMM with real gloo processes on the CPU: two
and four ranks of api.train_sharded against the port's single-process
run and the JAX package's train_sharded on the same weights (the
counterparts of tests/test_sharding.py and tests/test_multihost.py).

Each rank count is one spawn that runs every case in order (the ranks'
start-up dominates the cost), through a FileStore under the test's
temporary directory."""

import os

import jax
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu import api as j_api
from admm_lstm_tpu.models.lstm import init_lstm_params as j_init_lstm_params
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_torch import api
from admm_lstm_torch.ckpt.checkpoint import CheckpointManager
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.models.lstm import params_from_numpy
from admm_lstm_torch.parallel import pad_batch
from admm_lstm_torch.parallel.launch import run_cases, spawn
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

SPAWN_TIMEOUT = 120
ATOL = 1e-5            # tests/test_sharding.py:44-77,243-303
RHO_RTOL = 1e-6
HIDDEN = 5

TX, TY, VX, VY = synth(batch=64, seq_len=6, input_size=2, output_size=1,
                       val_batch=16)
J_PARAMS = j_init_lstm_params(jax.random.PRNGKey(0), 2, HIDDEN, 1)
WEIGHTS = tuple(np.array(w) for w in J_PARAMS)

# name -> (ADMMConfig fields, the train_sharded keywords, batch)
CASES = {
    'default': (dict(epochs=3), {}, 64),
    'turbo': (dict(epochs=5, sweep_mode='jacobi', exact_weight_solve=True,
                   matmul_precision='default'), {}, 64),
    'adaptive_rho': (dict(epochs=8, adaptive_rho=True), {}, 64),
    'padded': (dict(epochs=3), {}, 15),
    'best': (dict(epochs=12), dict(track_best=True), 64),
    'stop': (dict(epochs=40), dict(stop_tol=0.5, track_best=True), 64),
    'bf16_slabs': (dict(epochs=3, dtype='bfloat16'), {}, 64),
    'full': (dict(epochs=6), dict(record_residuals=True), 64),
    'part': (dict(epochs=3), dict(record_residuals=True, checkpoint_every=3,
                                  async_checkpoint=False), 64),
    'resumed': (dict(epochs=6), dict(record_residuals=True), 64),
}
COMPARED = ('default', 'turbo', 'adaptive_rho', 'padded', 'bf16_slabs')


def _case(name, world, ckpt):
    fields, kw, batch = CASES[name]
    kw = dict(kw)
    if name == 'part':
        kw['checkpoint_dir'] = ckpt
    if name == 'resumed':
        kw['resume_from'] = ckpt
    return dict(train_x=TX[:batch], train_y=TY[:batch], val_x=VX, val_y=VY,
                parameter_set=parameter_set('Synthetic'),
                config=ADMMConfig(hidden_size=HIDDEN, mesh_shape=(world,),
                                  **fields),
                params=params_from_numpy(*WEIGHTS), log_every=0,
                device='cpu', **kw)


def _spawn(world, names, tmp_path_factory):
    work = tmp_path_factory.mktemp(f'ranks{world}')
    ckpt = str(work / 'ckpt')
    ranks = spawn(run_cases, world,
                  args=([(api.train_sharded, _case(n, world, ckpt))
                         for n in names],),
                  backend='gloo', timeout=SPAWN_TIMEOUT, threads=1,
                  workdir=str(work))
    return [dict(zip(names, per_rank)) for per_rank in ranks], ckpt


@pytest.fixture(scope='module')
def two(tmp_path_factory):
    """Every case on two ranks: [rank 0's results, rank 1's], and the
    checkpoint directory."""
    return _spawn(2, list(CASES), tmp_path_factory)


@pytest.fixture(scope='module')
def four(tmp_path_factory):
    return _spawn(4, ['default'], tmp_path_factory)[0]


def _one_process(name, **kw):
    """The port's single-process run of a case, on the padded batch."""
    fields, case_kw, batch = CASES[name]
    x, y = pad_batch(TX[:batch], TY[:batch], 2)
    kw = {**{k: v for k, v in case_kw.items() if 'checkpoint' not in k},
          **kw}
    return api.train(x, y, VX, VY, parameter_set('Synthetic'),
                     ADMMConfig(hidden_size=HIDDEN, **fields),
                     params=params_from_numpy(*WEIGHTS), log_every=0,
                     device='cpu', **kw)


def _jax_sharded(name, world):
    fields, kw, batch = CASES[name]
    kw = {k: v for k, v in kw.items() if 'checkpoint' not in k}
    return j_api.train_sharded(
        TX[:batch], TY[:batch], VX, VY, j_parameter_set('Synthetic'),
        JConfig(hidden_size=HIDDEN, mesh_shape=(world,), **fields),
        params=J_PARAMS, log_every=0, **kw)


def _f32(a):
    """A port tensor or a JAX array (bf16 slabs too) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _held(got, want, label):
    """Weights, gates.h and duals.c at 1e-5, rho at rtol 1e-6 and the
    losses at rtol 1e-5 (test_sharding.py's tolerances)."""
    g, w = got['state'], want['state']
    for k in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(_f32(getattr(got['params'], k)),
                                   _f32(getattr(want['params'], k)),
                                   atol=ATOL, err_msg=f'{label} {k}')
    np.testing.assert_allclose(_f32(g.gates.h), _f32(w.gates.h),
                               atol=ATOL, err_msg=f'{label} gates.h')
    np.testing.assert_allclose(_f32(g.duals.c), _f32(w.duals.c),
                               atol=ATOL, err_msg=f'{label} duals.c')
    for k in 'ifgochy':
        np.testing.assert_allclose(float(getattr(g.rho, k)),
                                   float(getattr(w.rho, k)),
                                   rtol=RHO_RTOL, err_msg=f'{label} rho_{k}')
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               rtol=1e-5, atol=1e-7, err_msg=label)
    np.testing.assert_allclose(got['val_loss'], want['val_loss'],
                               rtol=1e-5, atol=1e-7, err_msg=label)


@pytest.mark.parametrize('name', COMPARED)
def test_torch_two_ranks_match_one_process_and_jax(two, name):
    got = two[0][0][name]
    assert got['mesh']['world'] == 2 and got['mesh']['backend'] == 'gloo'
    assert got['mesh']['all_reduces'] > 0
    assert got['state'].batch_size == (16 if name == 'padded' else 64)
    assert got['state'].gates.h.dtype == (
        torch.bfloat16 if name == 'bf16_slabs' else torch.float32)
    _held(got, _one_process(name), f'{name} vs the port in one process')
    _held(got, _jax_sharded(name, 2), f'{name} vs JAX')


@pytest.mark.parametrize('name', list(CASES))
def test_torch_two_ranks_weights_bit_equal(two, name):
    """Every rank computes the weights from the same all-reduced sums."""
    r0, r1 = two[0][0][name], two[0][1][name]
    for k in ('params', 'final_params'):
        for a, b in zip(r0[k], r1[k]):
            assert torch.equal(a, b), (name, k)
    for a, b in zip(r0['state'][:5], r1['state'][:5]):
        for ta, tb in zip(a, b):
            assert torch.equal(ta, tb), name
    assert r0['val_loss'] == r1['val_loss']
    assert (r0['mesh']['rank'], r1['mesh']['rank']) == (0, 1)


def test_torch_two_ranks_resume_is_bit_equal(two):
    """Checkpoint at epoch 3 of 6, resume: epochs 4..6, their losses,
    residuals and the whole final state equal the uninterrupted run's bit
    for bit (the counterpart of test_sharding.py:177)."""
    (ranks, ckpt) = two
    full, part, resumed = (ranks[0][k] for k in ('full', 'part', 'resumed'))
    assert resumed['val_loss'] == full['val_loss'][3:]
    assert resumed['train_loss'] == full['train_loss'][3:]
    assert part['residuals'] == full['residuals'][:3]
    assert resumed['residuals'] == full['residuals'][3:]
    assert len(full['residuals']) == 6
    assert all(np.isfinite(v) for d in full['residuals'] for v in d.values())
    for a, b in zip(resumed['state'][:5], full['state'][:5]):
        for ta, tb in zip(a, b):
            assert torch.equal(ta, tb)
    # Rank 0 wrote train's format: the whole state, loadable in one process.
    saved = CheckpointManager(ckpt).restore(device='cpu')
    assert saved.epoch == 3 and saved.batch_size == 64
    assert sorted(os.listdir(ckpt)) == ['step_3.pt']


def test_torch_two_ranks_residuals_match_one_process(two):
    got = two[0][0]['full']['residuals']
    want = _one_process('full')['residuals']
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_allclose([g[k] for k in g], [w[k] for k in w],
                                   rtol=1e-4, atol=1e-7)


def test_torch_two_ranks_track_best_matches_one_process(two):
    """The counterpart of test_sharding.py:437: the same best epoch and
    best weights as the single-process tracker and JAX's sharded one."""
    dp = two[0][0]['best']
    for ref in (_one_process('best'), _jax_sharded('best', 2)):
        assert dp['best_epoch'] == ref['best_epoch']
        np.testing.assert_allclose(np.asarray(dp['params'].wy),
                                   np.asarray(ref['params'].wy), atol=ATOL)
        np.testing.assert_allclose(dp['val_loss'], ref['val_loss'],
                                   rtol=1e-5, atol=1e-7)


def test_torch_two_ranks_stop_where_one_process_stops(two):
    """The convergence check reads global residuals, so both ranks stop
    at the epoch one process stops at."""
    r0, r1 = two[0][0]['stop'], two[0][1]['stop']
    ref = _one_process('stop')
    assert len(r0['val_loss']) == len(r1['val_loss']) == len(ref['val_loss'])
    assert len(ref['val_loss']) == 26          # converged at epoch 25
    assert r0['best_epoch'] == ref['best_epoch']
    np.testing.assert_allclose(r0['val_loss'], ref['val_loss'], rtol=1e-5,
                               atol=1e-7)


def test_torch_four_ranks_match_one_process_and_jax(four):
    """The counterpart of test_multihost.py's four-process step."""
    r0 = four[0]['default']
    assert r0['mesh']['world'] == 4
    _held(r0, _one_process('default'), 'four ranks vs one process')
    _held(r0, _jax_sharded('default', 4), 'four ranks vs JAX')
    for other in four[1:]:
        for a, b in zip(r0['params'], other['default']['params']):
            assert torch.equal(a, b)
