"""The plain reference against the port, on the CPU at toy sizes, under
both rule sets: a training run (every epoch's losses and the final
weights) and a rho search on the candidate axis (every candidate's
losses).  The port's CPU path runs the plain versions of its kernels;
the reference shares no code with it."""

import numpy as np
import pytest
import torch

from admm_lstm_torch import api, tune
from admm_lstm_torch.models.lstm import LSTMParams
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.logging import set_console_enabled
from portbench.jobs import candidate_grid
from portbench.reference import admm_lstm as ref

PS = {'rho': {'i': 1.0, 'f': 1.0, 'g': 1.0, 'o': 1.0, 'c': 0.008,
              'h': 0.00045, 'y': 5.62e-05},
      'beta': {k: 8e-07 for k in ('wi', 'vi', 'wf', 'vf', 'wg', 'vg', 'wo',
                                  'vo', 'wy')}}
DEFAULT = (ADMMConfig, ref.Rules())
TURBO = (lambda **kw: ADMMConfig.turbo(exact_solve_max_dim=1024, **kw),
         ref.Rules(sweep='jacobi', exact_max_dim=1024, bf16_gram=True))


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv('ADMM_TORCH_NO_FILELOG', '1')
    set_console_enabled(False)
    yield
    set_console_enabled(True)


def _problem(b, t, i, h, o, bv, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b + bv, t, i, generator=gen).cumsum(1) * 0.1
    y = torch.tanh(x.mean(-1)[:, -1:] + 0.1 * torch.arange(o))
    p = LSTMParams(torch.randn(4, i, h, generator=gen) * (2 / (i + h)) ** .5,
                   torch.randn(4, h, h, generator=gen) * h ** -.5,
                   torch.randn(h, o, generator=gen) * (2 / (h + o)) ** .5)
    return (x[:b], y[:b], x[b:], y[b:]), p


def _batch_minor(data):
    x, y, vx, vy = data
    x_im = x.permute(1, 2, 0).contiguous()
    return (x_im, y.T.contiguous(),
            torch.cat([x_im, vx.permute(1, 2, 0)], -1).contiguous(),
            vy.T.contiguous())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize('rules', [DEFAULT, TURBO], ids=['default', 'turbo'])
@pytest.mark.parametrize('shape', [(16, 5, 3, 4, 1, 8), (24, 4, 2, 3, 2, 6)],
                         ids=['o1', 'o2'])
def test_training_run_matches_the_port(rules, shape):
    make, ref_rules = rules
    data, p = _problem(*shape)
    got = api.train(*data, PS, config=make(hidden_size=shape[3], epochs=3),
                    params=p, log_every=0, device='cpu')
    x, y, x_all, vy = _batch_minor(data)
    rho = [PS['rho'][k] for k in ref.RHO_KEYS]
    train, val, final = ref.train_run(p.wx, p.wh, p.wy, x, y, x_all, vy, rho,
                                      PS['beta'], 3, ref_rules)
    assert len(train) == len(got['train_loss']) == 4
    assert _rel(got['train_loss'], train) < 2e-6
    assert _rel(got['val_loss'], val) < 2e-6
    for a, b in zip(got['params'], final):
        assert float((a - b).norm() / b.norm()) < 2e-5


def test_wide_bf16_gram_and_blocked_solve_match_the_port():
    """At a width where the exact stage rounds its Gram operands to bf16
    (4H D T B > 2^25) and solves D > 128 blocked: the two round the
    Gram's products in another order, so they agree to bf16 rounding."""
    make, ref_rules = TURBO
    data, p = _problem(400, 5, 140, 32, 6, 32, seed=1)
    got = api.train(*data, PS, config=make(hidden_size=32, epochs=2),
                    params=p, log_every=0, device='cpu')
    x, y, x_all, vy = _batch_minor(data)
    rho = [PS['rho'][k] for k in ref.RHO_KEYS]
    train, val, final = ref.train_run(p.wx, p.wh, p.wy, x, y, x_all, vy, rho,
                                      PS['beta'], 2, ref_rules)
    assert _rel(got['train_loss'], train) < 1e-4
    assert _rel(got['val_loss'], val) < 1e-4
    wx = float((got['params'].wx - final[0]).norm() / final[0].norm())
    assert 1e-7 < wx < 1e-2


@pytest.mark.parametrize('rules', [DEFAULT, TURBO], ids=['default', 'turbo'])
def test_rho_search_matches_the_port(rules):
    make, ref_rules = rules
    data, p = _problem(16, 5, 3, 4, 1, 8, seed=2)
    cands = candidate_grid(PS['rho'], (0.2, 5.0), ('c',), ref.RHO_KEYS)
    assert cands.shape == (2, 7)
    got = tune.search_rho(*data, PS, config=make(hidden_size=4),
                          candidates=cands, epochs=3, params=p, device='cpu')
    x, y, x_all, vy = _batch_minor(data)
    rho = [PS['rho'][k] for k in ref.RHO_KEYS]
    train, val = ref.rho_search(p.wx, p.wh, p.wy, x, y, x_all, vy, rho,
                                cands, PS['beta'], 3, ref_rules)
    assert _rel(got['train_losses'], train) < 2e-6
    assert _rel(got['val_losses'], val) < 2e-6
    # The port's winner is the reference's, up to a near-tie.
    assert val[got['order'][0]] <= val.min() * (1 + 2e-6)


def test_candidate_grid_is_the_ports_rule():
    from admm_lstm_torch.utils.config import ParameterSet
    mine = candidate_grid(PS['rho'], (0.2, 1.0, 5.0), ('c', 'h', 'y'),
                          ref.RHO_KEYS)
    assert np.array_equal(mine, tune.candidate_grid(
        ParameterSet.from_dict(PS)))
