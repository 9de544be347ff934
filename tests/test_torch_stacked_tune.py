"""The port's stacked rho search and preset (tune.search_rho_stacked,
tune.refine_rho_stacked, api.train_best_stacked) against the JAX
package's, on the CPU, from JAX's seed-0 weights."""

import os

import jax
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu import api as j_api
from admm_lstm_tpu import tune as j_tune
from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_tpu.variants import stacked as js
from admm_lstm_torch import api, tune
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.variants import stacked as ts

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

HIDDENS = (5, 4)
EPOCHS = 5
# f32: summation order between the packages, over EPOCHS epochs.
RTOL = 1e-4


@pytest.fixture(scope='module')
def problem():
    tx, ty, vx, vy = synth(batch=48, seq_len=6, input_size=2, output_size=1,
                           val_batch=8)
    jp = js.init_stacked(jax.random.PRNGKey(0), 2, HIDDENS, 1)
    w = {}
    for k, layer in enumerate(jp.layers):
        for gi, g in enumerate('ifgo'):
            w[f'l{k}_x2{g}'] = np.array(layer.wx[gi])
            w[f'l{k}_h2{g}'] = np.array(layer.wh[gi])
        w[f'l{k}_wy'] = np.array(layer.wy)
    w['wy'] = np.array(jp.wy)
    return (tx, ty, vx, vy), ts.stacked_params_from_dict(w)


def _assert_same_search(got, ref):
    """The same winner and candidates; every loss within RTOL."""
    assert got['best_rho'] == ref['best_rho']
    assert got['best_parameter_set'].as_dict() == \
        ref['best_parameter_set'].as_dict()
    np.testing.assert_array_equal(got['candidates'], ref['candidates'])
    np.testing.assert_allclose(got['val_losses'], ref['val_losses'],
                               rtol=RTOL)
    np.testing.assert_allclose(got['train_losses'], ref['train_losses'],
                               rtol=RTOL)
    assert got['order'][0] == ref['order'][0]


@pytest.mark.parametrize('span', [10.0, 10.0 ** 0.5])
def test_torch_stacked_refine_grid_matches_jax(span):
    """The 3-point-per-key grid of a stacked refinement round."""
    base = parameter_set('Stacked')
    mult = (1.0 / span, 1.0, span)
    got = tune.candidate_grid(base, multipliers=mult)
    ref = j_tune.candidate_grid(j_parameter_set('Stacked'), multipliers=mult)
    assert got.shape == (27, 7)
    np.testing.assert_array_equal(got, ref)


def test_torch_refine_loop_points_per_key():
    """_refine_loop builds 5 or 3 points per key, as JAX's."""
    seen = {}

    def search_call(tag):
        def call(best, cands):
            seen.setdefault(tag, []).append(np.asarray(cands))
            return {'best_parameter_set': best, 'best_rho': dict(best.rho),
                    'best_val_loss': 0.0}
        return call

    for points in (5, 3):
        tune._refine_loop(search_call(('torch', points)),
                          parameter_set('Stacked'), 2, ('c', 'h'), 10.0,
                          points_per_key=points)
        j_tune._refine_loop(search_call(('jax', points)),
                            j_parameter_set('Stacked'), 2, ('c', 'h'), 10.0,
                            points_per_key=points)
        assert seen[('torch', points)][0].shape == (points ** 2, 7)
        for a, b in zip(seen[('torch', points)], seen[('jax', points)]):
            np.testing.assert_array_equal(a, b)


def test_torch_search_rho_stacked_matches_jax(problem):
    (tx, ty, vx, vy), params = problem
    cfg = dict(hidden_size=HIDDENS[0])
    ref = j_tune.search_rho_stacked(tx, ty, vx, vy,
                                    j_parameter_set('Stacked'), HIDDENS,
                                    JConfig(**cfg), epochs=EPOCHS)
    got = tune.search_rho_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                                  HIDDENS, ADMMConfig(**cfg), epochs=EPOCHS,
                                  params=params, device='cpu')
    assert len(got['val_losses']) == 27
    _assert_same_search(got, ref)
    assert 'z' not in got['best_rho']


def test_torch_search_rho_stacked_z_candidates_match_jax(problem):
    """z_candidates: the winner's rho_z folds back into the result."""
    (tx, ty, vx, vy), params = problem
    base = parameter_set('Stacked')
    # rho_y apart enough that no two candidates' losses lie within 100x
    # the packages' agreement (a few 1e-7) of each other.
    cands = np.repeat(tune.candidate_grid(base, multipliers=(0.2, 5.0),
                                          keys=('y',)), 2, axis=0)
    zs = np.asarray([0.02, 50.0, 0.02, 50.0], np.float32)
    ref = j_tune.search_rho_stacked(tx, ty, vx, vy,
                                    j_parameter_set('Stacked'), HIDDENS,
                                    JConfig(), candidates=cands,
                                    epochs=EPOCHS, z_candidates=zs)
    got = tune.search_rho_stacked(tx, ty, vx, vy, base, HIDDENS, ADMMConfig(),
                                  candidates=cands, epochs=EPOCHS,
                                  z_candidates=zs, params=params,
                                  device='cpu')
    _assert_same_search(got, ref)
    assert got['best_z'] == ref['best_z']
    assert got['best_parameter_set'].rho['z'] == got['best_z']


def test_torch_refine_rho_stacked_matches_jax(problem):
    """One round: 27 candidates, the base rho_z re-attached."""
    (tx, ty, vx, vy), params = problem
    ref = j_tune.refine_rho_stacked(tx, ty, vx, vy,
                                    j_parameter_set('Stacked'), HIDDENS,
                                    JConfig(), epochs=EPOCHS, rounds=1)
    got = tune.refine_rho_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                                  HIDDENS, ADMMConfig(), epochs=EPOCHS,
                                  rounds=1, params=params, device='cpu')
    assert len(got['val_losses']) == 27
    _assert_same_search(got, ref)
    assert got['best_parameter_set'].rho['z'] == \
        parameter_set('Stacked').rho['z']
    assert [h['best_rho'] for h in got['history']] == \
        [h['best_rho'] for h in ref['history']]


def test_torch_train_best_stacked_matches_jax(problem):
    """A small budget: the same preset_choice, the probe losses and the
    committed trajectory within RTOL."""
    (tx, ty, vx, vy), params = problem
    cfg = dict(epochs=8, hidden_size=HIDDENS[0])
    ref = j_api.train_best_stacked(tx, ty, vx, vy,
                                   j_parameter_set('Stacked'),
                                   JConfig(**cfg), hiddens=HIDDENS,
                                   probe_epochs=4, search_rounds=1,
                                   log_every=0)
    got = api.train_best_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                                 ADMMConfig(**cfg), hiddens=HIDDENS,
                                 probe_epochs=4, search_rounds=1,
                                 log_every=0, params=params, device='cpu')
    assert got['preset_choice'] == ref['preset_choice']
    assert set(got['probe_val']) == {'shipped', 'tuned'}
    for k, v in ref['probe_val'].items():
        np.testing.assert_allclose(got['probe_val'][k], v, rtol=RTOL)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=RTOL)
    assert got['best_epoch'] == ref['best_epoch']
    assert got['candidate_rho']['shipped'] == parameter_set('Stacked').rho


def _oom_when(monkeypatch, too_big):
    """Makes the stacked epoch raise a CUDA out-of-memory error for every
    state that `too_big(state, epochs_done)` says does not fit (epochs_done:
    the epochs that groups of one trained before it); returns the
    candidate counts of the groups that trained an epoch."""
    real_step, groups = ts.stacked_admm_step_im, []

    def step(state, *args):
        if too_big(state, groups.count(1)):
            raise torch.cuda.OutOfMemoryError('CUDA out of memory')
        groups.append(state.candidates)
        return real_step(state, *args)

    monkeypatch.setattr(ts, 'stacked_admm_step_im', step)
    return groups


def test_torch_search_rho_stacked_out_of_memory_names_the_candidate(
        problem, monkeypatch):
    """Every group of more than one candidate runs out of memory, so the
    group halves down to single candidates; candidate 0 trains alone, and
    candidate 1, which does not fit either, raises with a note naming its
    index, after a warning for each halving."""
    (tx, ty, vx, vy), params = problem
    warned = []
    monkeypatch.setattr(tune, 'warning', warned.append)
    groups = _oom_when(monkeypatch, lambda state, done: state.candidates > 1
                       or done >= EPOCHS)
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        tune.search_rho_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                                HIDDENS, ADMMConfig(), epochs=EPOCHS,
                                params=params, device='cpu')
    assert groups == [1] * EPOCHS
    assert warned[0] == ('search_rho_stacked: candidates 0..26 ran out of '
                         'device memory as one group; halving it')
    assert any('candidates 1..2 ran out' in w for w in warned)
    assert any('search_rho_stacked: rho candidate 1 of 27' in note
               for note in info.value.__notes__)


def test_torch_search_rho_stacked_out_of_memory_halves_the_group(
        problem, monkeypatch):
    """Only groups of more than 8 candidates run out of memory: 27 halves
    to 13 and 14, and those to groups of 6 and 7, each one batched
    program, with losses equal to the unhalved run's."""
    (tx, ty, vx, vy), params = problem
    args = (tx, ty, vx, vy, parameter_set('Stacked'), HIDDENS, ADMMConfig())
    kw = dict(epochs=EPOCHS, params=params, device='cpu')
    whole = tune.search_rho_stacked(*args, **kw)
    groups = _oom_when(monkeypatch,
                       lambda state, _: state.candidates > 8)
    halved = tune.search_rho_stacked(*args, **kw)
    assert sorted(set(groups)) == [6, 7]
    assert sum(groups) == 27 * EPOCHS
    for key in ('train_losses', 'val_losses', 'order'):
        np.testing.assert_array_equal(halved[key], whole[key])
    assert halved['best_rho'] == whole['best_rho']
