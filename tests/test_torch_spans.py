"""The port's spans (utils/observe.span): one shared no-op while no
profiler records; under a CPU `torch.profiler` session the names, counts
and nesting of the spans of both models' training runs and rho
searches; and the same numbers traced and untraced."""

import contextlib
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from admm_lstm_torch import api, tune
from admm_lstm_torch.data import load_dataset
from admm_lstm_torch.models.lstm import params_from_dict
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.observe import span

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

HIDDEN = 5
EPOCHS = 3
# Where each line search's host read may sit.
READ_PARENTS = {'weights.x', 'weights.h', 'sweep.final'}
CONFIGS = {
    'default': ADMMConfig(hidden_size=HIDDEN, epochs=EPOCHS),
    'adaptive_rho': ADMMConfig(hidden_size=HIDDEN, epochs=EPOCHS,
                               adaptive_rho=True),
    'turbo': ADMMConfig.turbo(hidden_size=HIDDEN, epochs=EPOCHS),
}


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


def _spans(prof):
    """(name, start ns, end ns) of every span the session recorded."""
    return sorted((e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation())


def _parent(spans, inner):
    """The name of the innermost other span around `inner`, or None."""
    name, start, end = inner
    around = [s for s in spans if s is not inner
              and s[1] <= start and end <= s[2]]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


def _train(data, config, traced):
    tx, ty, vx, vy, w = data
    session = (profile(activities=[ProfilerActivity.CPU]) if traced
               else contextlib.nullcontext())
    with session as prof:
        res = api.train(tx, ty, vx, vy, parameter_set('GoogleStock'),
                        config=config, params=params_from_dict(w),
                        log_every=0, device='cpu')
    return res, prof


def test_torch_span_off_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = span('epoch')
    assert off is span('weights.x')
    assert isinstance(off, contextlib.nullcontext)
    with off, off:               # reentrant: spans nest
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span('epoch')
        assert on is not off
        with on:
            torch.ones(4).sum()
    assert [s[0] for s in _spans(prof)] == ['epoch']


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_torch_train_spans(synthetic, name):
    """A 3-epoch run: one `train`, `init` and `collect`; per epoch one
    `epoch`, `wy`, `weights.x`, `weights.h`, `sweep.interior`,
    `sweep.final` and `loss`, `residuals` under adaptive rho; every `read`
    inside a weight stage or the final step, none under the exact stage's
    x side (turbo)."""
    config = CONFIGS[name]
    _, prof = _train(synthetic, config, traced=True)
    spans = _spans(prof)
    count = Counter(s[0] for s in spans)
    residuals = EPOCHS if config.adaptive_rho else 0
    assert {k: count[k] for k in
            ('train', 'init', 'collect', 'epoch', 'wy', 'weights.x',
             'weights.h', 'sweep.interior', 'sweep.final', 'loss',
             'residuals')} == {
        'train': 1, 'init': 1, 'collect': 1, 'epoch': EPOCHS,
        'wy': EPOCHS, 'weights.x': EPOCHS, 'weights.h': EPOCHS,
        'sweep.interior': EPOCHS, 'sweep.final': EPOCHS, 'loss': EPOCHS,
        'residuals': residuals}
    assert set(count) <= {'train', 'init', 'collect', 'epoch', 'wy',
                          'weights.x', 'weights.h', 'sweep.interior',
                          'sweep.final', 'loss', 'residuals', 'read'}
    reads = [s for s in spans if s[0] == 'read']
    assert reads
    parents = Counter(_parent(spans, r) for r in reads)
    assert set(parents) <= READ_PARENTS, parents
    if config.exact_weight_solve:          # I = 1: the x stage is exact
        assert 'weights.x' not in parents
    for s in spans:
        if s[0] in ('wy', 'weights.x', 'weights.h', 'sweep.interior',
                    'sweep.final', 'residuals'):
            assert _parent(spans, s) == 'epoch', s
        elif s[0] in ('epoch', 'init', 'collect', 'loss'):
            assert _parent(spans, s) == 'train', s


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_torch_traced_and_untraced_runs_are_bit_equal(synthetic, name):
    plain, _ = _train(synthetic, CONFIGS[name], traced=False)
    traced, _ = _train(synthetic, CONFIGS[name], traced=True)
    assert plain['train_loss'] == traced['train_loss']
    assert plain['val_loss'] == traced['val_loss']
    for a, b in zip(plain['params'], traced['params']):
        assert torch.equal(a, b)


STACKED = (4, 3, 3)
STACKED_STAGES = ('wy', 'weights.x', 'weights.h', 'weights.upper',
                  'sweep.interior', 'sweep.final')


def _stacked_epoch(data, traced):
    """One depth-3 stacked epoch from a fresh state, under a profiler or
    not."""
    from admm_lstm_torch.core.step import rules_for
    from admm_lstm_torch.variants.stacked import (init_stacked,
                                                  init_stacked_state,
                                                  stacked_admm_step_im)
    tx, ty = (torch.as_tensor(np.asarray(v, np.float32)) for v in data[:2])
    params = init_stacked(torch.Generator().manual_seed(2), 1, STACKED, 1)
    state = init_stacked_state(params, tx, parameter_set('Stacked'))
    session = (profile(activities=[ProfilerActivity.CPU]) if traced
               else contextlib.nullcontext())
    with session as prof:
        out = stacked_admm_step_im(state, tx.permute(1, 2, 0).contiguous(),
                                   ty.T.contiguous(),
                                   rules_for(ADMMConfig()))
    return out, prof


def test_torch_stacked_epoch_spans(synthetic):
    """One stacked epoch: an `epoch` around `wy`, layer 0's `weights.x`
    and `weights.h`, one `weights.upper` per upper layer, `sweep.interior`
    and `sweep.final`; the final-h search's reads inside `sweep.final`."""
    _, prof = _stacked_epoch(synthetic, traced=True)
    spans = _spans(prof)
    count = Counter(s[0] for s in spans)
    assert dict(count) == {'epoch': 1, 'wy': 1, 'weights.x': 1,
                           'weights.h': 1, 'weights.upper': 2,
                           'sweep.interior': 1, 'sweep.final': 1,
                           'read': count['read']}
    assert count['read'] >= 1
    for s in spans:
        if s[0] in STACKED_STAGES:
            assert _parent(spans, s) == 'epoch', s
        elif s[0] == 'read':
            assert _parent(spans, s) == 'sweep.final', s


def _search(model, data):
    """A 2-candidate search of `model` ('lstm' or 'stacked') over 2
    epochs."""
    tx, ty, vx, vy, w = data
    base = parameter_set('GoogleStock' if model == 'lstm' else 'Stacked')
    kw = dict(candidates=tune.candidate_grid(base, multipliers=(0.5, 2.0),
                                             keys=('y',)),
              epochs=2, device='cpu')
    if model == 'lstm':
        return tune.search_rho(tx, ty, vx, vy, base,
                               config=ADMMConfig(hidden_size=HIDDEN),
                               params=params_from_dict(w), **kw)
    from admm_lstm_torch.variants.stacked import init_stacked
    return tune.search_rho_stacked(
        tx, ty, vx, vy, base, STACKED[:2], config=ADMMConfig(),
        params=init_stacked(torch.Generator().manual_seed(2), 1,
                            STACKED[:2], 1), **kw)


@pytest.mark.parametrize('model', ['lstm', 'stacked'])
def test_torch_search_spans(synthetic, model):
    """A 2-candidate search, either model: one `search` around `init` and
    one `group`, which holds an `epoch` per batched epoch and the `loss`;
    the epoch's stages inside its `epoch`."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _search(model, synthetic)
    spans = _spans(prof)
    count = Counter(s[0] for s in spans)
    epochs = 2
    assert {k: count[k] for k in ('search', 'init', 'group', 'epoch',
                                  'loss', 'train', 'weights.upper')} == {
        'search': 1, 'init': 1, 'group': 1, 'epoch': epochs, 'loss': 1,
        'train': 0, 'weights.upper': epochs if model == 'stacked' else 0}
    for s in spans:
        if s[0] in ('epoch', 'loss'):
            assert _parent(spans, s) == 'group', s
        elif s[0] in ('init', 'group'):
            assert _parent(spans, s) == 'search', s
        elif s[0] in STACKED_STAGES:
            assert _parent(spans, s) == 'epoch', s


def test_torch_stacked_train_spans(synthetic):
    """A 3-epoch `train_stacked` run, as `api.train`'s: one `train`
    around one `init` and one `collect`, and per epoch one `epoch` and
    one `loss`, each upper layer's `weights.upper` inside the epoch."""
    from admm_lstm_torch.variants.stacked import init_stacked, train_stacked
    tx, ty, vx, vy, _ = synthetic
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                      ADMMConfig(epochs=EPOCHS), log_every=0,
                      params=init_stacked(torch.Generator().manual_seed(2),
                                          1, STACKED, 1), device='cpu')
    spans = _spans(prof)
    count = Counter(s[0] for s in spans)
    assert {k: count[k] for k in ('train', 'init', 'collect', 'epoch',
                                  'loss', 'weights.upper')} == {
        'train': 1, 'init': 1, 'collect': 1, 'epoch': EPOCHS,
        'loss': EPOCHS, 'weights.upper': EPOCHS * (len(STACKED) - 1)}
    for s in spans:
        if s[0] in ('epoch', 'init', 'collect', 'loss'):
            assert _parent(spans, s) == 'train', s
        elif s[0] in STACKED_STAGES:
            assert _parent(spans, s) == 'epoch', s


def test_torch_stacked_traced_and_untraced_epochs_are_bit_equal(synthetic):
    plain, _ = _stacked_epoch(synthetic, traced=False)
    traced, _ = _stacked_epoch(synthetic, traced=True)
    for a, b in zip(plain.params.tensors(), traced.params.tensors()):
        assert torch.equal(a, b)
    for a, b in zip(plain.zs + plain.gates[-1][:6],
                    traced.zs + traced.gates[-1][:6]):
        assert torch.equal(a, b)
