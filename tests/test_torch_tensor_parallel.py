"""Hidden-axis tensor parallelism of the port (H sharded over the 'model'
axis of a 2-D (data, model) mesh) with real gloo processes on the CPU,
against the JAX package's unsharded trajectory on the same numpy weights
and data (the counterparts of tests/test_sharding.py::
test_tensor_parallel_hidden_sharding, ::test_tensor_parallel_exact_solve_
h128 and ::test_tensor_parallel_exact_solve_blocktri), and
api.train_sharded on a 2-D mesh (data parallelism over 'data', the
'model' ranks replicas) against the JAX package's.

Each rank count is one spawn that runs every case in order in one
process group (parallel/launch.run_cases)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu import api as j_api
from admm_lstm_tpu.core.init import init_admm_state as j_init_admm_state
from admm_lstm_tpu.core.step import make_admm_step as j_make_admm_step
from admm_lstm_tpu.models.lstm import LSTMParams as JParams
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_torch import api
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.models.lstm import params_from_numpy
from admm_lstm_torch.parallel.launch import run_cases, run_layout, spawn
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.solvers import normal_eq as ne
from admm_lstm_torch.utils.config import ADMMConfig

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

SPAWN_TIMEOUT = 240
ATOL = 1e-5            # tests/test_sharding.py:229-234
ATOL_EXACT = 5e-5      # tests/test_sharding.py:373-378, 417-420
RHO_RTOL = 1e-6
AXES = ('data', 'model')


def _weights(inputs, hidden, seed=1):
    """Xavier-normal (wx, wh, wy) from numpy, one output."""
    rng = np.random.default_rng(seed)
    w = lambda a, b: (np.sqrt(2.0 / (a + b))
                      * rng.standard_normal((a, b))).astype(np.float32)
    return (np.stack([w(inputs, hidden) for _ in range(4)]),
            np.stack([w(hidden, hidden) for _ in range(4)]), w(hidden, 1))


EXACT = dict(exact_weight_solve=True, use_pallas_chol=False)
# name -> (mesh, config fields, T, I, H, B, epochs)
CASES = {
    # test_sharding.py:205: the default config (Gauss-Seidel) at H = 8.
    'default': ((1, 2), {}, 6, 2, 8, 64, 3),
    'default_2x2': ((2, 2), {}, 6, 2, 8, 64, 3),
    # The Jacobi sweep, the exact solve and adaptive rho under TP.
    'auto': ((1, 2), 'auto', 6, 2, 8, 64, 3),
    # test_sharding.py:336: H = 128, the exact solve; the h-stage's Gram is
    # the fused einsum at B = 64 and the chunked wide contraction at 256.
    'exact_h128': ((1, 2), EXACT, 4, 3, 128, 64, 2),
    'exact_h128_wide': ((1, 2), EXACT, 4, 3, 128, 256, 2),
    # test_sharding.py:392: the x-stage at D = 160 takes the block-
    # triangular Gram (a 128 block and a 32 tail) past the einsum budget.
    'blocktri': ((1, 2), dict(EXACT, exact_solve_max_dim=512), 4, 160, 32,
                 512, 2),
}
TWO = ('default', 'auto', 'exact_h128', 'exact_h128_wide', 'blocktri')
FOUR = ('default_2x2',)
# api.train_sharded on a 2-D mesh: B = 30 pads to 32 (the mesh's 4 ranks),
# two data blocks of 16, each held by two 'model' replicas.
TRAIN_2D = dict(epochs=3, hidden_size=5, mesh_shape=(2, 2), mesh_axes=AXES)


def _config(fields, hidden, cls):
    if fields == 'auto':
        return cls.auto(hidden_size=hidden)
    return cls(hidden_size=hidden, **fields)


def _problem(name):
    _, _, seq_len, inputs, hidden, batch, _ = CASES[name]
    data = synth(batch=batch, seq_len=seq_len, input_size=inputs,
                 output_size=1, val_batch=8)
    return data, _weights(inputs, hidden)


def _run_args(name):
    mesh, fields, _, _, hidden, _, epochs = CASES[name]
    data, w = _problem(name)
    return dict(mesh_shape=mesh, axis_names=AXES, model_axis='model',
                config=_config(fields, hidden, ADMMConfig),
                parameter_set=parameter_set('Synthetic'),
                params=params_from_numpy(*w), data=data, epochs=epochs,
                device='cpu')


def _train_2d_args():
    tx, ty, vx, vy = synth(batch=30, seq_len=5, input_size=2, output_size=1,
                           val_batch=12)
    return dict(train_x=tx, train_y=ty, val_x=vx, val_y=vy,
                parameter_set=parameter_set('Synthetic'),
                config=ADMMConfig(**TRAIN_2D),
                params=params_from_numpy(*_weights(2, 5)), log_every=0,
                record_residuals=True, device='cpu')


def _spawn(calls, world, tmp_path_factory):
    work = tmp_path_factory.mktemp(f'tp{world}')
    ranks = spawn(run_cases, world, args=(calls,), backend='gloo',
                  timeout=SPAWN_TIMEOUT, threads=1, workdir=str(work))
    return [list(r) for r in zip(*ranks)]


@pytest.fixture(scope='module')
def two(tmp_path_factory):
    """{case: [rank 0's result, rank 1's]} of every two-rank case."""
    got = _spawn([(run_layout, _run_args(n)) for n in TWO], 2,
                 tmp_path_factory)
    return dict(zip(TWO, got))


@pytest.fixture(scope='module')
def four(tmp_path_factory):
    """The four-rank cases and api.train_sharded on the (2, 2) mesh."""
    got = _spawn([(run_layout, _run_args(n)) for n in FOUR]
                 + [(api.train_sharded, _train_2d_args())], 4,
                 tmp_path_factory)
    return dict(zip(FOUR + ('train_2d',), got))


def _jax_unsharded(name):
    """The JAX package's unsharded trajectory: make_admm_step(cfg,
    donate=False) for the case's epochs."""
    _, fields, _, _, hidden, _, epochs = CASES[name]
    (tx, ty, _, _), w = _problem(name)
    cfg = _config(fields, hidden, JConfig)
    state = j_init_admm_state(JParams(*(jnp.asarray(a) for a in w)),
                              jnp.asarray(tx), j_parameter_set('Synthetic'),
                              cfg)
    step = j_make_admm_step(cfg, donate=False)
    for _ in range(epochs):
        state = step(state, jnp.asarray(tx), jnp.asarray(ty))
    return state


def _held(got, want, atol, label):
    for k in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(getattr(got.params, k).numpy(),
                                   np.asarray(getattr(want.params, k)),
                                   atol=atol, err_msg=f'{label} {k}')
    for k in ('c', 'h', 'a'):
        np.testing.assert_allclose(getattr(got.gates, k).numpy(),
                                   np.asarray(getattr(want.gates, k)),
                                   atol=atol, err_msg=f'{label} gates.{k}')
    for k in ('f', 'c', 'h'):
        np.testing.assert_allclose(getattr(got.duals, k).numpy(),
                                   np.asarray(getattr(want.duals, k)),
                                   atol=atol, err_msg=f'{label} duals.{k}')
    for k in 'ifgochy':
        np.testing.assert_allclose(float(getattr(got.rho, k)),
                                   float(getattr(want.rho, k)),
                                   rtol=RHO_RTOL, err_msg=f'{label} rho_{k}')


def _ranks(two, four, name):
    return (two if name in TWO else four)[name]


@pytest.mark.parametrize('name', TWO + FOUR)
def test_torch_tensor_parallel_matches_jax_unsharded(two, four, name):
    atol = ATOL if CASES[name][1] in ({},) else ATOL_EXACT
    _held(_ranks(two, four, name)[0]['state'], _jax_unsharded(name), atol,
          name)


@pytest.mark.parametrize('name', TWO + FOUR)
def test_torch_tensor_parallel_ranks_agree(two, four, name):
    """Every rank gathers the same state, bit for bit, and takes the same
    rho and losses after every epoch; each holds its H block, and the
    layout round trip is bit-equal."""
    ranks = _ranks(two, four, name)
    mesh, _, seq_len, _, hidden, batch, _ = CASES[name]
    for r in ranks:
        assert r['round_trip']
        assert r['block'] == (seq_len + 1, hidden // mesh[1],
                              batch // mesh[0])
        assert r['rho'] == ranks[0]['rho']
        assert r['val_loss'] == ranks[0]['val_loss']
        for ga, gb in zip(r['state'][:5], ranks[0]['state'][:5]):
            for a, b in zip(ga, gb):
                assert torch.equal(a, b)


def test_torch_tensor_parallel_gram_strategy_is_one_process(monkeypatch):
    """The cases reach the Gram paths they stand for: on the global shape
    (4H columns, T*B rows) that every 'model' rank passes, as one process
    picks them."""
    assert ne._gram_strategy(4 * 128, 128, 4 * 64) == 'einsum'
    assert ne._gram_strategy(4 * 128, 128, 4 * 256) == 'wide'
    assert ne._gram_strategy(4 * 32, 160, 4 * 512) == 'blocktri'
    seen = []
    real = ne._gram_strategy
    monkeypatch.setattr(ne, '_gram_strategy',
                        lambda k, d, n: seen.append((k, d, n))
                        or real(k, d, n))
    s2, m = torch.rand(3, 8, 5), torch.rand(3, 2, 5)
    ne.gauss_newton_ridge_update_wide(
        m, s2, torch.rand(2, 8), s2, torch.ones(4), torch.ones(4),
        torch.arange(8) // 2 == 2, total_rows=30, total_cols=16)
    assert seen == [(16, 2, 30)]


@pytest.mark.parametrize('name', ['default', 'auto', 'default_2x2'])
def test_torch_tensor_parallel_collectives_per_axis(two, four, name):
    """Per epoch on the 'model' axis: the old h gathered to the whole H
    once, the weights for the losses (three gathers); under Gauss-Seidel
    the new weights (two) and the interior slabs (one) for the gathered
    sweep, under Jacobi the fresh h at T-1 (one) and, with adaptive rho,
    the new h for the residuals (one).  The h·wy partial sums are all-
    reduced.  The 'data' axis all-reduces only where it holds batch
    blocks."""
    mesh, fields, *_, epochs = CASES[name]
    gathers = 1 + 3 + (3 if fields == {} else 2)
    for r in _ranks(two, four, name):
        data, model = (r['mesh']['collectives'][k] for k in ('data',
                                                             'model'))
        assert model['all_gather']['calls'] == gathers * epochs
        assert model['all_reduce']['calls'] >= 4 * epochs
        assert model['halo']['calls'] == model['broadcast']['calls'] == 0
        assert (data['all_reduce']['calls'] > 0) == (mesh[0] > 1)
        assert data['halo']['calls'] == data['broadcast']['calls'] == 0


def test_torch_train_sharded_2d_mesh_matches_jax(four):
    """api.train_sharded on a (2, 2) mesh is data parallelism over 'data'
    with the 'model' ranks as replicas, as JAX's train_sharded on the same
    mesh (api.py:713-723): the batch padded to the mesh's 4 ranks, the
    sums over 'data' only."""
    ranks = four['train_2d']
    tx, ty, vx, vy = synth(batch=30, seq_len=5, input_size=2, output_size=1,
                           val_batch=12)
    want = j_api.train_sharded(
        tx, ty, vx, vy, j_parameter_set('Synthetic'), JConfig(**TRAIN_2D),
        params=JParams(*(jnp.asarray(a) for a in _weights(2, 5))),
        log_every=0, record_residuals=True)
    got = ranks[0]
    assert got['mesh']['shape'] == (2, 2)
    assert got['state'].batch_size == 32
    assert got['mesh']['collectives']['model']['all_reduce']['calls'] == 0
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got['val_loss'], want['val_loss'],
                               rtol=1e-5, atol=1e-7)
    for k in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(getattr(got['params'], k).numpy(),
                                   np.asarray(getattr(want['params'], k)),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got['state'].gates.h.numpy(),
                               np.asarray(want['state'].gates.h), atol=ATOL)
    for g, w in zip(got['residuals'], want['residuals']):
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w],
                                   rtol=1e-4, atol=1e-7)
    for r in ranks[1:]:
        assert r['val_loss'] == got['val_loss']
        for a, b in zip(r['params'], got['params']):
            assert torch.equal(a, b)
