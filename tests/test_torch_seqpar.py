"""The time-sharded Jacobi layout (sequence parallelism) of the port with
real gloo processes on the CPU, against the JAX package's unsharded
trajectory on the same numpy weights and data (the counterparts of
tests/test_sharding.py::test_time_sharded_jacobi_matches_unsharded and
tests/test_longseq.py::test_time_sharded_jacobi_matches_unsharded_long_t),
and the layout's units: the ceil split, the halo, the bit-equal round
trip of shard_state/gather_state and the collectives per axis.

Each rank count is one spawn that runs every case in order in one
process group (parallel/launch.run_cases of run_layout)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu.core.init import init_admm_state as j_init_admm_state
from admm_lstm_tpu.core.step import make_admm_step as j_make_admm_step
from admm_lstm_tpu.models.lstm import LSTMParams as JParams
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_torch.core.consensus import Consensus, time_block
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.models.lstm import params_from_numpy
from admm_lstm_torch.parallel import Mesh, block_ranges
from admm_lstm_torch.parallel.launch import run_cases, run_layout, spawn
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

SPAWN_TIMEOUT = 240
ATOL = 1e-5            # tests/test_sharding.py:128-131, test_longseq.py:81
ATOL_EXACT = 5e-5      # tests/test_sharding.py:373-378 (the exact solve)
RHO_RTOL = 1e-6


def _weights(inputs, hidden, seed=0):
    """Xavier-normal (wx, wh, wy) from numpy, one output."""
    rng = np.random.default_rng(seed)
    w = lambda a, b: (np.sqrt(2.0 / (a + b))
                      * rng.standard_normal((a, b))).astype(np.float32)
    return (np.stack([w(inputs, hidden) for _ in range(4)]),
            np.stack([w(hidden, hidden) for _ in range(4)]), w(hidden, 1))


# name -> (mesh, axis names, model axis, config fields, T, H, B, epochs)
CASES = {
    # test_sharding.py:104: T+1 = 7 rows over 2 ranks, 4 and 3.
    'uneven': ((2,), ('data',), None, dict(sweep_mode='jacobi'), 6, 5, 64,
               3),
    'auto': ((2,), ('data',), None, 'auto', 6, 5, 64, 4),
    # test_longseq.py:24: T+1 = 256 rows over 4 ranks.
    'long_t': ((4,), ('data',), None, dict(sweep_mode='jacobi'), 255, 4, 32,
               3),
    # Time x model: rows over 'data', H over 'model', the Lipschitz wy step
    # (its Gram needs the whole H of h_T on the last time block).
    'time_model': ((2, 2), ('data', 'model'), 'model',
                   dict(sweep_mode='jacobi', wy_lipschitz=True,
                        with_dual_y=True), 6, 8, 64, 3),
    # One row per rank: block 0 holds only row 0, the last only row T (its
    # fresh h and c at T-1 come from the previous rank, a second halo).
    'one_row': ((4,), ('data',), None,
                dict(sweep_mode='jacobi', adaptive_rho=True), 3, 4, 32, 3),
}
TWO = ('uneven', 'auto')
FOUR = ('long_t', 'time_model', 'one_row')


def _config(fields, hidden, cls):
    if fields == 'auto':
        return cls.auto(hidden_size=hidden)
    return cls(hidden_size=hidden, **fields)


def _problem(name):
    _, _, _, _, seq_len, hidden, batch, _ = CASES[name]
    data = synth(batch=batch, seq_len=seq_len, input_size=2, output_size=1,
                 val_batch=16)
    return data, _weights(2, hidden)


def _run_args(name):
    mesh, axes, model_axis, fields, _, hidden, _, epochs = CASES[name]
    data, w = _problem(name)
    return dict(mesh_shape=mesh, axis_names=axes, shard_time=True,
                model_axis=model_axis, config=_config(fields, hidden,
                                                      ADMMConfig),
                parameter_set=parameter_set('Synthetic'),
                params=params_from_numpy(*w), data=data, epochs=epochs,
                device='cpu')


def _spawn(names, world, tmp_path_factory):
    work = tmp_path_factory.mktemp(f'seqpar{world}')
    ranks = spawn(run_cases, world,
                  args=([(run_layout, _run_args(n)) for n in names],),
                  backend='gloo', timeout=SPAWN_TIMEOUT, threads=1,
                  workdir=str(work))
    return {n: [r[k] for r in ranks] for k, n in enumerate(names)}


@pytest.fixture(scope='module')
def two(tmp_path_factory):
    """{case: [rank 0's result, rank 1's]} of every two-rank case."""
    return _spawn(TWO, 2, tmp_path_factory)


@pytest.fixture(scope='module')
def four(tmp_path_factory):
    return _spawn(FOUR, 4, tmp_path_factory)


def _jax_unsharded(name):
    """The JAX package's unsharded trajectory: make_admm_step(cfg,
    donate=False) for the case's epochs."""
    _, _, _, fields, _, hidden, _, epochs = CASES[name]
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
    for k in ('i', 'c', 'y'):
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
def test_torch_time_sharded_matches_jax_unsharded(two, four, name):
    ranks = _ranks(two, four, name)
    atol = ATOL_EXACT if CASES[name][3] == 'auto' else ATOL
    _held(ranks[0]['state'], _jax_unsharded(name), atol, name)


@pytest.mark.parametrize('name', TWO + FOUR)
def test_torch_time_sharded_ranks_agree(two, four, name):
    """Every rank gathers the same state, bit for bit, and takes the same
    rho after every epoch and the same losses."""
    ranks = _ranks(two, four, name)
    for r in ranks[1:]:
        assert r['rho'] == ranks[0]['rho']
        assert r['val_loss'] == ranks[0]['val_loss']
        assert r['train_loss'] == ranks[0]['train_loss']
        for ga, gb in zip(r['state'][:5], ranks[0]['state'][:5]):
            for a, b in zip(ga, gb):
                assert torch.equal(a, b)


@pytest.mark.parametrize('name', TWO + FOUR)
def test_torch_time_sharded_blocks_and_round_trip(two, four, name):
    """Each rank holds its ceil-split block of the T+1 rows (and its H
    block on a 2-D mesh); gather_state(shard_state(state)) is the state
    bit for bit."""
    mesh_shape, _, model_axis, _, seq_len, hidden, batch, _ = CASES[name]
    n_model = mesh_shape[1] if len(mesh_shape) == 2 else 1
    for rank, r in enumerate(_ranks(two, four, name)):
        lo, hi = time_block(seq_len + 1, rank // n_model, mesh_shape[0])
        assert r['block'] == (hi - lo, hidden // n_model, batch)
        assert r['round_trip']


def test_torch_time_block_is_the_ceil_split():
    """GSPMD's split: ceil((T+1)/n) rows a block, the last shorter."""
    assert [time_block(513, k, 2) for k in range(2)] == [(0, 257),
                                                         (257, 513)]
    assert [time_block(7, k, 2) for k in range(2)] == [(0, 4), (4, 7)]
    assert [time_block(7, k, 4) for k in range(4)] == [(0, 2), (2, 4),
                                                       (4, 6), (6, 7)]
    assert [time_block(256, k, 8) for k in range(8)] == [
        (32 * k, 32 * k + 32) for k in range(8)]
    mesh = Mesh(shape=(4,), axis_names=('data',), rank=0, world=4,
                device=torch.device('cpu'), backend=None, host_group=None,
                consensus=Consensus(world=4), coords=(0,))
    with pytest.raises(ValueError, match='empty'):
        block_ranges(mesh, (0, 0), 3, 4, 8, shard_time=True)
    assert block_ranges(mesh, (3, 0), 7, 4, 8, shard_time=True) == (
        (6, 7), (0, 4), (0, 8))


class _Rows(Consensus):
    """Rank `index` of `world` whose gather returns every rank's row: rank
    k sends k + its row."""

    def _gather(self, t):
        return torch.stack([t + k for k in range(self.world)])


def test_torch_halo_is_the_previous_ranks_row():
    row = torch.zeros(2, 3)
    assert _Rows(world=4, index=0).halo(row) is None
    for index in (1, 2, 3):
        axis = _Rows(world=4, index=index)
        assert torch.equal(axis.halo(row), row + index - 1)
        assert axis.counts()['halo'] == {'calls': 1, 'bytes': 24}
    assert Consensus().halo(row) is None       # one rank: no neighbour


@pytest.mark.parametrize('name', ['uneven', 'long_t', 'one_row'])
def test_torch_time_sharded_collectives_per_axis(two, four, name):
    """Per epoch on the time axis: one halo of the old (h, c) rows, a
    second when the last block holds only row T, one more for the
    residuals under adaptive rho; two broadcasts (wy, then `a`); all
    sums over t all-reduced.  The 'model' axis makes none."""
    _, _, _, fields, _, _, _, epochs = CASES[name]
    halos = 1 + (name == 'one_row') + bool(fields.get('adaptive_rho'))
    for r in _ranks(two, four, name):
        data, model = (r['mesh']['collectives'][k] for k in ('data',
                                                             'model'))
        assert data['halo']['calls'] == halos * epochs
        assert data['broadcast']['calls'] == 2 * epochs
        assert data['all_reduce']['calls'] >= 4 * epochs
        assert data['all_gather']['calls'] == 0
        assert all(v['calls'] == 0 for v in model.values())
