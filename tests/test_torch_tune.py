"""The port's rho search (admm_lstm_torch.tune) and train_best's rho-searched
candidate against the JAX package's, on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu import api as j_api
from admm_lstm_tpu import tune as j_tune
from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.models.lstm import params_from_dict as j_params_from_dict
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_tpu.variants import stacked as js
from admm_lstm_torch import api, tune
from admm_lstm_torch.data import load_dataset
from admm_lstm_torch.models.lstm import params_from_dict
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.variants import stacked as ts

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

HIDDEN = 5
EPOCHS = 8
STACKED_HIDDENS = (5, 4)
# f32: summation order between the packages, over EPOCHS epochs.
RTOL = 1e-4


@pytest.fixture(scope='module')
def synthetic():
    (tx, ty, vx, vy), _, _ = load_dataset('Synthetic', batch=64, seq_len=5,
                                          val_batch=16)
    rng = np.random.default_rng(4)
    w = {f'x2{g}': (rng.standard_normal((1, HIDDEN)) * 0.5)
         .astype(np.float32) for g in 'ifgo'}
    w.update({f'h2{g}': (rng.standard_normal((HIDDEN, HIDDEN)) * 0.4)
              .astype(np.float32) for g in 'ifgo'})
    w['wy'] = (rng.standard_normal((HIDDEN, 1)) * 0.5).astype(np.float32)
    return tx, ty, vx, vy, w


def _assert_same_ranking(got, ref):
    """Equal best rho and val losses at RTOL; the same order, except that
    candidates whose JAX losses agree within RTOL may swap places."""
    assert got['best_rho'] == ref['best_rho']
    np.testing.assert_allclose(got['val_losses'], ref['val_losses'],
                               rtol=RTOL)
    np.testing.assert_allclose(got['train_losses'], ref['train_losses'],
                               rtol=RTOL)
    np.testing.assert_array_equal(got['candidates'], ref['candidates'])
    ref_val = np.asarray(ref['val_losses'])
    for a, b in zip(got['order'], ref['order']):
        if a != b:
            np.testing.assert_allclose(ref_val[a], ref_val[b], rtol=RTOL)


@pytest.mark.parametrize('keys,mult', [(('c', 'h', 'y'), (0.2, 1.0, 5.0)),
                                       (('i', 'y'), (0.5, 2.0))])
def test_torch_candidate_grid_matches_jax(keys, mult):
    base = parameter_set('GoogleStock')
    got = tune.candidate_grid(base, multipliers=mult, keys=keys)
    ref = j_tune.candidate_grid(j_parameter_set('GoogleStock'),
                                multipliers=mult, keys=keys)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_torch_search_rho_matches_jax(synthetic):
    """The default 27-point grid: the same ranking as the JAX package's
    vmapped search, candidate by candidate."""
    tx, ty, vx, vy, w = synthetic
    ref = j_tune.search_rho(tx, ty, vx, vy, j_parameter_set('Synthetic'),
                            JConfig(hidden_size=HIDDEN), epochs=EPOCHS,
                            params=j_params_from_dict(w))
    got = tune.search_rho(tx, ty, vx, vy, parameter_set('Synthetic'),
                          ADMMConfig(hidden_size=HIDDEN), epochs=EPOCHS,
                          params=params_from_dict(w), device='cpu')
    assert len(got['val_losses']) == 27
    np.testing.assert_array_equal(got['order'], ref['order'])
    _assert_same_ranking(got, ref)
    assert got['best_val_loss'] == pytest.approx(ref['best_val_loss'],
                                                 rel=RTOL)
    assert got['best_parameter_set'].as_dict() == \
        ref['best_parameter_set'].as_dict()


def test_torch_refine_rho_matches_jax(synthetic):
    """One round of the 125-point refinement grid."""
    tx, ty, vx, vy, w = synthetic
    ref = j_tune.refine_rho(tx, ty, vx, vy, j_parameter_set('Synthetic'),
                            JConfig(hidden_size=HIDDEN), epochs=EPOCHS,
                            rounds=1, params=j_params_from_dict(w))
    got = tune.refine_rho(tx, ty, vx, vy, parameter_set('Synthetic'),
                          ADMMConfig(hidden_size=HIDDEN), epochs=EPOCHS,
                          rounds=1, params=params_from_dict(w), device='cpu')
    assert len(got['val_losses']) == 125
    _assert_same_ranking(got, ref)
    assert len(got['history']) == 1
    assert got['history'][0]['best_rho'] == ref['history'][0]['best_rho']
    assert got['history'][0]['span'] == ref['history'][0]['span']


def test_torch_train_best_search_rounds_matches_jax(synthetic):
    """train_best(search_rounds=1): the third, rho-searched candidate."""
    tx, ty, vx, vy, w = synthetic
    ref = j_api.train_best(tx, ty, vx, vy, j_parameter_set('Synthetic'),
                           JConfig(epochs=EPOCHS, hidden_size=HIDDEN),
                           params=j_params_from_dict(w), search_rounds=1,
                           log_every=0)
    got = api.train_best(tx, ty, vx, vy, parameter_set('Synthetic'),
                         ADMMConfig(epochs=EPOCHS, hidden_size=HIDDEN),
                         params=params_from_dict(w), search_rounds=1,
                         log_every=0, device='cpu')
    assert got['preset_choice'] == ref['preset_choice']
    assert set(got['probe_val']) == {'shipped', 'auto', 'tuned'}
    for k, v in ref['probe_val'].items():
        np.testing.assert_allclose(got['probe_val'][k], v, rtol=RTOL)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=RTOL)


def test_torch_search_rho_nonfinite_candidates_rank_last(synthetic):
    """A candidate whose run diverges ranks after every finite one, as in
    the JAX package."""
    tx, ty, vx, vy, w = synthetic
    base = parameter_set('Synthetic')
    cands = tune.candidate_grid(base, multipliers=(1.0,), keys=('c',))
    cands = np.concatenate([cands, cands])
    cands[0, -1] = np.inf                        # rho_y = inf diverges
    got = tune.search_rho(tx, ty, vx, vy, base,
                          ADMMConfig(hidden_size=HIDDEN), candidates=cands,
                          epochs=2, params=params_from_dict(w), device='cpu')
    assert not np.isfinite(got['val_losses'][0])
    assert list(got['order']) == [1, 0]
    assert np.isfinite(got['best_val_loss'])


@pytest.fixture(scope='module')
def stacked_problem():
    """tests/test_torch_stacked_tune.py's problem: JAX's seed-0 stacked
    weights of widths STACKED_HIDDENS on JAX's synthetic data."""
    tx, ty, vx, vy = synth(batch=48, seq_len=6, input_size=2, output_size=1,
                           val_batch=8)
    jp = js.init_stacked(jax.random.PRNGKey(0), 2, STACKED_HIDDENS, 1)
    w = {'wy': np.array(jp.wy)}
    for k, layer in enumerate(jp.layers):
        for gi, g in enumerate('ifgo'):
            w[f'l{k}_x2{g}'] = np.array(layer.wx[gi])
            w[f'l{k}_h2{g}'] = np.array(layer.wh[gi])
        w[f'l{k}_wy'] = np.array(layer.wy)
    return (tx, ty, vx, vy), ts.stacked_params_from_dict(w)


def _search(model, epochs, synthetic, stacked_problem):
    """(search, base, epoch module, epoch name) of `model`: search() runs
    its default 27-point search over `epochs` epochs from fixed weights,
    and its epoch is the module global `name` of `module`, which the
    search reads when it is called."""
    if model == 'lstm':
        tx, ty, vx, vy, w = synthetic
        base = parameter_set('Synthetic')
        return (lambda: tune.search_rho(
            tx, ty, vx, vy, base, ADMMConfig(hidden_size=HIDDEN),
            epochs=epochs, params=params_from_dict(w), device='cpu'),
            base, tune, 'admm_step_im')
    (tx, ty, vx, vy), params = stacked_problem
    base = parameter_set('Stacked')
    return (lambda: tune.search_rho_stacked(
        tx, ty, vx, vy, base, STACKED_HIDDENS, ADMMConfig(), epochs=epochs,
        params=params, device='cpu'), base, ts, 'stacked_admm_step_im')


def _oom_when(monkeypatch, module, name, too_big):
    """Makes the epoch `module.name` raise a CUDA out-of-memory error for
    every state that `too_big(state)` says does not fit; returns the
    candidate counts of the groups that trained an epoch."""
    real_step, groups = getattr(module, name), []

    def step(state, *args):
        if too_big(state):
            raise torch.cuda.OutOfMemoryError('CUDA out of memory')
        groups.append(state.candidates)
        return real_step(state, *args)

    monkeypatch.setattr(module, name, step)
    return groups


@pytest.mark.parametrize('model,epochs,limit,sizes',
                         [('lstm', 2, 4, [3, 4]), ('stacked', 5, 8, [6, 7])])
def test_torch_search_out_of_memory_halves_the_group(
        synthetic, stacked_problem, monkeypatch, model, epochs, limit,
        sizes):
    """Either model's search: an out-of-memory error above a group of
    `limit` candidates halves the group until it fits (27 -> 13, 14 ->
    ... -> groups of `sizes`), each one batched program, with results
    equal to the unhalved run (JAX's `_run_in_groups`)."""
    search, _, module, name = _search(model, epochs, synthetic,
                                      stacked_problem)
    whole = search()
    groups = _oom_when(monkeypatch, module, name,
                       lambda st: st.candidates > limit)
    halved = search()
    assert sorted(set(groups)) == sizes
    assert sum(groups) == 27 * epochs            # every candidate, each epoch
    for key in ('train_losses', 'val_losses', 'order'):
        np.testing.assert_array_equal(halved[key], whole[key])
    assert halved['best_rho'] == whole['best_rho']


@pytest.mark.parametrize('model,epochs', [('lstm', EPOCHS), ('stacked', 5)])
def test_torch_search_out_of_memory_names_the_candidate(
        synthetic, stacked_problem, monkeypatch, model, epochs):
    """Either model's search: every group that holds candidate 1 runs out
    of memory, so the groups halve down to single candidates; candidate 0
    trains alone, and candidate 1, which does not fit either, raises the
    CUDA out-of-memory error with a note naming its index, after a
    warning for each halving."""
    search, base, module, name = _search(model, epochs, synthetic,
                                         stacked_problem)
    cands = tune.candidate_grid(base)
    # Candidate 1's (c, h, y) is unique in the grid.
    holds_1 = lambda st: bool(
        (torch.isclose(st.rho.c, torch.tensor(cands[1, 4]))
         & torch.isclose(st.rho.h, torch.tensor(cands[1, 5]))
         & torch.isclose(st.rho.y, torch.tensor(cands[1, 6]))).any())
    groups = _oom_when(monkeypatch, module, name, holds_1)
    warned = []
    monkeypatch.setattr(tune, 'warning', warned.append)
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        search()
    search_name = 'search_rho' if model == 'lstm' else 'search_rho_stacked'
    assert groups == [1] * epochs
    assert warned[0] == (f'{search_name}: candidates 0..26 ran out of '
                         f'device memory as one group; halving it')
    assert any('candidates 1..2 ran out' in w for w in warned)
    assert any(f'{search_name}: rho candidate 1 of 27' in note
               for note in info.value.__notes__)
