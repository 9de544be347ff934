"""The comparison that decides `correct`: a job's answers on the program
against the plain reference's.

  * loss_gap: the largest relative gap |p - r| / |r| over every loss the
    job returns (a training run: each epoch's train and validation loss,
    the initial ones too; a search: each candidate's final train and
    validation loss).  Where both are non-finite the gap is 0, where one
    is, infinite.
  * early_loss_gap (a training run): loss_gap over the initial losses and
    those of the first EARLY_EPOCHS epochs.  Each epoch's doubling
    searches accept or reject a theta by a sum against a threshold, and a
    few of those tests fall within float32 rounding of it: there the
    program and the reference may take different thetas, and the run's
    later losses and final weights part by up to what a lower precision
    gives (PERF.md §2).  Before many such tests the two agree to
    rounding, so this number carries the tight limit, and loss_gap and
    weight_gap limits above what a near-tie gives.
  * weight_gap (a training run): the gap in the weights' change, leaf
    by leaf over wx, wh and wy: |(p - w0) - (r - w0)| over the larger of
    |r - w0| and the median leaf's |r - w0| (w0 the initial weights,
    Frobenius norms), the worst leaf's.  A run whose state never moves
    reads 1.
  * median_gap (a search): the median over the candidates of each
    candidate's larger relative gap (train or validation).  The widest
    gap follows the one candidate whose trajectory is the most sensitive
    to rounding; the median follows the search as a whole.
  * rank_regret (a search): how far the reference's validation loss of
    the program's best candidate lies above the reference's best, relative
    to the latter.
"""

from __future__ import annotations

import numpy as np
import torch

EARLY_EPOCHS = 3


def _rel_gaps(p, r) -> np.ndarray:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    both = ~np.isfinite(p) & ~np.isfinite(r)
    one = np.isfinite(p) != np.isfinite(r)
    with np.errstate(all='ignore'):
        gap = np.abs(p - r) / np.abs(r)
    gap = np.where(both, 0.0, np.where(one, np.inf, gap))
    return np.nan_to_num(gap, nan=np.inf)


def loss_gap(prog: dict, refr: dict) -> float:
    return float(max(_rel_gaps(prog['train'], refr['train']).max(),
                     _rel_gaps(prog['val'], refr['val']).max()))


def early_loss_gap(prog: dict, refr: dict) -> float:
    n = EARLY_EPOCHS + 1
    return loss_gap({k: prog[k][:n] for k in ('train', 'val')},
                    {k: refr[k][:n] for k in ('train', 'val')})


def median_gap(prog: dict, refr: dict) -> float:
    return float(np.median(np.maximum(_rel_gaps(prog['train'], refr['train']),
                                      _rel_gaps(prog['val'], refr['val']))))


def weight_gap(prog: dict, refr: dict) -> float:
    moved = [r.double() - w0.double().to(r.device)
             for r, w0 in zip(refr['weights'], refr['initial'])]
    norms = [float(torch.linalg.norm(d)) for d in moved]
    scale = max(float(np.median(norms)), 1e-30)
    gaps = [float(torch.linalg.norm(
                (p.double().to(d.device) - w0.double().to(d.device)) - d))
            / max(n, scale)
            for p, w0, d, n in zip(prog['weights'], refr['initial'], moved,
                                   norms)]
    gaps = [g if np.isfinite(g) else np.inf for g in gaps]
    return max(gaps)


def rank_regret(prog: dict, refr: dict) -> float:
    val = np.where(np.isfinite(refr['val']), refr['val'], np.inf)
    best = float(val.min())
    if not np.isfinite(best):
        return np.inf
    return float((val[int(prog['order'][0])] - best) / abs(best))


NUMBERS = {'train': {'loss_gap': loss_gap, 'weight_gap': weight_gap,
                     'early_loss_gap': early_loss_gap},
           'rho_search': {'loss_gap': loss_gap, 'median_gap': median_gap,
                          'rank_regret': rank_regret}}


def compare(kind: str, prog: dict, refr: dict) -> dict:
    return {name: fn(prog, refr) for name, fn in NUMBERS[kind].items()}
