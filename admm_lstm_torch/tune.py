"""Rho search: train a grid of penalty tunings and rank them.

Counterpart of `admm_lstm_tpu/tune.py` (`candidate_grid`, `search_rho`,
`refine_rho`).  The reference tunes its 7 penalty coefficients by hand,
editing source between runs (README.md:79-83).  Here every candidate
trains from the same initial weights and the same initial ADMM state,
differing only in rho, and the candidates are ranked by their final
validation loss (a non-finite loss ranks last).

The JAX package trains the whole grid as one vmapped program.  The
port's kernels take no candidate axis and its line searches sync the
host, so the port trains the candidates one after another through the
same epoch code as `api.train` (`core/step.admm_step_im`), with the CUDA
kernels on CUDA tensors.  Each candidate's numbers are those of a run
alone, as the JAX package's masked line searches make them.  With one
candidate at a time there is no group to halve when the card runs out of
memory (the JAX package's `_run_in_groups`), so a CUDA out-of-memory
error propagates, naming the candidate that raised it.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from admm_lstm_torch.api import _as_tensor, batch_minor
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.state import Penalties
from admm_lstm_torch.core.step import admm_step_im, rules_for
from admm_lstm_torch.models.lstm import init_lstm_params, train_val_mse_im
from admm_lstm_torch.utils.config import RHO_KEYS, ADMMConfig, ParameterSet
from admm_lstm_torch.utils.device import matmul_precision, resolve_device


def candidate_grid(base: ParameterSet,
                   multipliers: Sequence[float] = (0.2, 1.0, 5.0),
                   keys: Sequence[str] = ('c', 'h', 'y')) -> np.ndarray:
    """Log-grid of rho candidates: the base tuning scaled per key.

    Returns (N, 7) float32 in canonical i,f,g,o,c,h,y order; the other
    penalties stay at their base values.
    """
    base_vec = np.asarray([base.rho[k] for k in RHO_KEYS], np.float32)
    out = []
    for combo in itertools.product(multipliers, repeat=len(keys)):
        vec = base_vec.copy()
        for k, m in zip(keys, combo):
            vec[RHO_KEYS.index(k)] *= m
        out.append(vec)
    return np.stack(out)


def search_rho(train_x, train_y, val_x, val_y, base: ParameterSet,
               config: ADMMConfig = ADMMConfig(),
               candidates: Optional[np.ndarray] = None,
               epochs: int = 30, params=None,
               device='cuda') -> Dict[str, object]:
    """Train every rho candidate for `epochs` epochs; return them ranked.

    candidates: (N, 7) rho vectors (default: `candidate_grid(base)`).
    params: the initial weights every candidate starts from (default: the
    Xavier-normal init from `torch.Generator().manual_seed(config.seed)`).

    Returns a dict with 'order' (candidate indices, best first),
    'train_losses' and 'val_losses' (N,), 'candidates', 'best_rho',
    'best_val_loss' and 'best_parameter_set' (the winning rho with the
    base beta).
    """
    if isinstance(base, dict):
        base = ParameterSet.from_dict(base)
    rules = rules_for(config)
    device = resolve_device(device)
    if candidates is None:
        candidates = candidate_grid(base)
    candidates = np.asarray(candidates, np.float32)
    with matmul_precision(config.matmul_precision):
        train_x, train_y = (_as_tensor(train_x, device),
                            _as_tensor(train_y, device))
        val_x, val_y = _as_tensor(val_x, device), _as_tensor(val_y, device)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed)
            params = init_lstm_params(gen, train_x.shape[2],
                                      config.hidden_size, train_y.shape[1],
                                      device=device)
        base_state = init_admm_state(params.to(device), train_x, base,
                                     config)
        x_im, y_im, xall_im, vy_im = batch_minor(train_x, train_y, val_x,
                                                 val_y)
        losses = []
        for n, cand in enumerate(candidates):
            # The step never writes its input state, so every candidate
            # starts from the same base_state.
            state = base_state._replace(rho=Penalties(*(
                torch.tensor(v, dtype=torch.float32, device=device)
                for v in cand)))
            try:
                for _ in range(epochs):
                    state = admm_step_im(state, x_im, y_im, rules)
                losses.append(torch.stack(train_val_mse_im(
                    state.params, xall_im, y_im, vy_im)))
            except torch.cuda.OutOfMemoryError as e:
                e.add_note(f'search_rho: rho candidate {n} of '
                           f'{len(candidates)} ({cand.tolist()}) ran out '
                           f'of device memory')
                raise
        losses = torch.stack(losses).cpu().numpy()
    train_losses, val_losses = losses[:, 0], losses[:, 1]
    val_rank = np.where(np.isfinite(val_losses), val_losses, np.inf)
    order = np.argsort(val_rank)
    best_rho = {k: float(candidates[order[0], i])
                for i, k in enumerate(RHO_KEYS)}
    return {
        'order': order,
        'train_losses': train_losses,
        'val_losses': val_losses,
        'candidates': candidates,
        'best_rho': best_rho,
        'best_val_loss': float(val_rank[order[0]]),
        'best_parameter_set': ParameterSet(rho=best_rho,
                                           beta=dict(base.beta)),
    }


def _refine_loop(search_call, base: ParameterSet, rounds: int,
                 keys: Sequence[str], span: float) -> Dict[str, object]:
    """Successive-halving recentering: each round trains a 5-point-per-key
    log-grid of candidates via `search_call(center, candidates)`,
    recenters on the winner, and narrows the per-key span by a square
    root."""
    best = base
    result: Dict[str, object] = {}
    history = []
    for r in range(rounds):
        mult = (1.0 / span, span ** -0.5, 1.0, span ** 0.5, span)
        cands = candidate_grid(best, multipliers=mult, keys=keys)
        result = search_call(best, cands)
        best = result['best_parameter_set']
        history.append({'round': r, 'span': span,
                        'best_rho': dict(result['best_rho']),
                        'best_val_loss': result['best_val_loss']})
        span = span ** 0.5
    result['history'] = history
    return result


def refine_rho(train_x, train_y, val_x, val_y, base: ParameterSet,
               config: ADMMConfig = ADMMConfig(), epochs: int = 30,
               rounds: int = 3, keys: Sequence[str] = ('c', 'h', 'y'),
               span: float = 10.0, params=None,
               device='cuda') -> Dict[str, object]:
    """Successive-halving rho refinement around the best grid point:
    `rounds` rounds of a 5-point-per-key grid (125 candidates for c, h,
    y) at span 10, then its square root, and so on."""
    return _refine_loop(
        lambda best, cands: search_rho(train_x, train_y, val_x, val_y,
                                       best, config=config,
                                       candidates=cands, epochs=epochs,
                                       params=params, device=device),
        base, rounds, keys, span)
