"""The stacked N-layer variant (variants/stacked.py) against the
benchmark's plain stacked reference (portbench/reference/admm_stacked.py)
on seeded random weights and data: `train_stacked` and
`tune.search_rho_stacked` at depth 2 and at depth 3, where a middle
layer both receives z from below and solves the coupled h against the
layer above.

Tolerances.  The program and the reference compute the same float32
epoch (the upper layers' solve in float64 on both sides) with their sums
in other orders, so they part by rounding only.  At these sizes a
loss's relative gap stays near 1e-7 after five epochs: LOSS_RTOL is ten
times that.  A weight leaf's gap, over the leaf's norm, stays near 2e-6
(the exact stages return the new weights themselves, so their rounding
is that of the weights, not of the step): WEIGHT_RTOL is fifty times
that.  Layer 0's Gram on bfloat16-rounded operands (the program's
'default' matmul precision, forced onto these small shapes through the
'wide' Gram) moves its h-side weights by about 5e-3 of their norm and
the losses by 3e-6 to 2e-5, outside both, which the last test shows.
"""

import os

import numpy as np
import pytest
import torch

from admm_lstm_torch import tune
from admm_lstm_torch.models.lstm import LSTMParams
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.solvers import normal_eq
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.variants.stacked import StackedParams, train_stacked
from portbench.reference import admm_stacked as ref
from portbench.reference.admm_lstm import Rules

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

B, BV, T, I, O = 48, 12, 5, 1, 1
EPOCHS = 5
LOSS_RTOL = 1e-6
WEIGHT_RTOL = 1e-4
DEPTHS = {'depth2': (6, 5), 'depth3': (6, 5, 4)}
BASE = parameter_set('Stacked')


def _case(hiddens, seed=3):
    """Data (B, T, I) etc. and the weight tuple (wx_0, wh_0, wy_0, ...,
    the head wy), Xavier-normal, from one generator."""
    gen = torch.Generator().manual_seed(seed)
    data = (torch.rand(B, T, I, generator=gen),
            torch.rand(B, O, generator=gen),
            torch.rand(BV, T, I, generator=gen),
            torch.rand(BV, O, generator=gen))

    def xavier(a, b):
        return torch.randn(a, b, generator=gen) * (2.0 / (a + b)) ** 0.5

    weights, prev = [], I
    for h in hiddens:
        weights += [torch.stack([xavier(prev, h) for _ in range(4)]),
                    torch.stack([xavier(h, h) for _ in range(4)]),
                    xavier(h, O)]
        prev = h
    return data, tuple(weights) + (xavier(prev, O),)


def _params(weights):
    n = (len(weights) - 1) // 3
    return StackedParams(layers=tuple(LSTMParams(*weights[3 * k:3 * k + 3])
                                      for k in range(n)), wy=weights[-1])


def _layout(data):
    tx, ty, vx, vy = data
    x = tx.permute(1, 2, 0).contiguous()
    return (x, ty.T.contiguous(),
            torch.cat([x, vx.permute(1, 2, 0)], dim=-1).contiguous(),
            vy.T.contiguous())


def _program_train(data, weights, hiddens, config):
    res = train_stacked(*data, BASE, config, log_every=0, hiddens=hiddens,
                        track_best=False, params=_params(weights),
                        device='cpu')
    return (np.asarray(res['train_loss']), np.asarray(res['val_loss']),
            res['params'].tensors())


def _reference_train(data, weights):
    rho = [BASE.rho[k] for k in ref.RHO_KEYS]
    return ref.train_run(weights, *_layout(data), rho, BASE.beta, EPOCHS,
                         Rules())


def _gaps(prog, refr):
    """(largest relative loss gap, largest weight gap over the leaf's
    norm)."""
    loss = max(float(np.max(np.abs(p - r) / np.abs(r)))
               for p, r in zip(prog[:2], refr[:2]))
    weight = max(float((p - r).norm() / r.norm())
                 for p, r in zip(prog[2], refr[2]))
    return loss, weight


@pytest.mark.parametrize('depth', sorted(DEPTHS))
def test_train_stacked_matches_the_reference(depth):
    hiddens = DEPTHS[depth]
    data, weights = _case(hiddens)
    prog = _program_train(data, weights, hiddens,
                          ADMMConfig(epochs=EPOCHS))
    refr = _reference_train(data, weights)
    assert len(prog[0]) == len(refr[0]) == EPOCHS + 1
    loss, weight = _gaps(prog, refr)
    assert loss <= LOSS_RTOL and weight <= WEIGHT_RTOL, (loss, weight)
    # The run moved: every layer's h-side weights changed.
    for k in range(len(hiddens)):
        assert not torch.equal(prog[2][3 * k + 1], weights[3 * k + 1])


@pytest.mark.parametrize('depth', sorted(DEPTHS))
def test_search_rho_stacked_matches_the_reference(depth):
    """Three candidates apart in rho_y, with a rho_z of their own each:
    every candidate's final losses, and the same ranking."""
    hiddens = DEPTHS[depth]
    data, weights = _case(hiddens, seed=5)
    cands = tune.candidate_grid(BASE, multipliers=(0.2, 1.0, 5.0),
                                keys=('y',))
    z = np.asarray([0.5, 1.0, 2.0], np.float32)
    out = tune.search_rho_stacked(*data, BASE, hiddens,
                                  config=ADMMConfig(), candidates=cands,
                                  epochs=EPOCHS - 1, z_candidates=z,
                                  params=_params(weights), device='cpu')
    train, val = ref.rho_search(weights, *_layout(data),
                                np.concatenate([cands, z[:, None]], axis=1),
                                BASE.beta, EPOCHS - 1, Rules())
    for p, r in ((out['train_losses'], train), (out['val_losses'], val)):
        assert np.max(np.abs(p - r) / np.abs(r)) <= LOSS_RTOL, (p, r)
    assert list(out['order']) == list(np.argsort(val))
    assert len(set(np.round(val, 6))) == 3        # no tie decides the rank


def test_bf16_gram_operands_fail_the_tolerance(monkeypatch):
    """Layer 0's Gram on bfloat16 operands: the 'wide' Gram (the one the
    published widths take) at matmul precision 'default' rounds them."""
    hiddens = DEPTHS['depth3']
    data, weights = _case(hiddens)
    refr = _reference_train(data, weights)
    monkeypatch.setattr(normal_eq, '_gram_strategy', lambda *a: 'wide')
    wide = _gaps(_program_train(data, weights, hiddens,
                                ADMMConfig(epochs=EPOCHS)), refr)
    rounded = _gaps(_program_train(
        data, weights, hiddens,
        ADMMConfig(epochs=EPOCHS, matmul_precision='default')), refr)
    assert wide[0] <= LOSS_RTOL and wide[1] <= WEIGHT_RTOL, wide
    assert rounded[0] > LOSS_RTOL, (wide, rounded)
    assert rounded[1] > 10 * WEIGHT_RTOL, (wide, rounded)
