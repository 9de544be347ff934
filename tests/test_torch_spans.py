"""The port's spans (utils/observe.span): one shared no-op while no
profiler records; under a CPU `torch.profiler` session the names, counts
and nesting of the spans of a training run and of a rho search; and the
same numbers traced and untraced."""

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


def test_torch_search_spans(synthetic):
    """A 2-candidate search: one `search`, `init`, `group` and `loss`, and
    `epoch` once per batched epoch inside the group."""
    tx, ty, vx, vy, w = synthetic
    base = parameter_set('GoogleStock')
    cands = tune.candidate_grid(base, multipliers=(0.5, 2.0), keys=('y',))
    epochs = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tune.search_rho(tx, ty, vx, vy, base,
                        config=ADMMConfig(hidden_size=HIDDEN),
                        candidates=cands, epochs=epochs,
                        params=params_from_dict(w), device='cpu')
    spans = _spans(prof)
    count = Counter(s[0] for s in spans)
    assert {k: count[k] for k in ('search', 'init', 'group', 'epoch',
                                  'loss', 'train')} == {
        'search': 1, 'init': 1, 'group': 1, 'epoch': epochs, 'loss': 1,
        'train': 0}
    for s in spans:
        if s[0] in ('epoch', 'loss'):
            assert _parent(spans, s) == 'group', s
        elif s[0] in ('init', 'group'):
            assert _parent(spans, s) == 'search', s


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_torch_traced_and_untraced_runs_are_bit_equal(synthetic, name):
    plain, _ = _train(synthetic, CONFIGS[name], traced=False)
    traced, _ = _train(synthetic, CONFIGS[name], traced=True)
    assert plain['train_loss'] == traced['train_loss']
    assert plain['val_loss'] == traced['val_loss']
    for a, b in zip(plain['params'], traced['params']):
        assert torch.equal(a, b)
