"""Rho search: train a grid of penalty tunings and rank them.

Counterpart of `admm_lstm_tpu/tune.py` (`candidate_grid`, `search_rho`,
`refine_rho`, and for the stacked variant `search_rho_stacked` and
`refine_rho_stacked`).  The reference tunes its 7 penalty coefficients
by hand, editing source between runs (README.md:79-83).  Here every
candidate trains from the same initial weights and the same initial
ADMM state, differing only in rho, and the candidates are ranked by
their final validation loss (a non-finite loss ranks last).

The JAX package trains the whole grid as one vmapped program
(`_vmapped_rho_search`), under any config, for one layer and for the
stacked variant.  So does `search_rho` here:
one state with the candidate axis (core/state.py) from the same initial
weights and state, rho from the candidates, `epochs` batched epochs of
the same epoch code as `api.train` (`core/step.admm_step_im`: on CUDA
tensors its sweep, Gauss-Seidel or Jacobi, is one kernel launch over
every candidate, and under turbo()/auto() each exact weight stage one
batched Cholesky solve), then one batched loss.  The line searches search
per candidate, so each candidate's numbers are those of a run alone, as
the JAX package's masked loops make them.  When the card runs out of
memory the group of candidates halves and each half trains on its own
(`_run_in_groups`, as the JAX package's).  `search_rho_stacked` does the
same with the stacked epoch (variants/stacked.py: the candidate axis
through its sweep, rho_z per candidate where `z_candidates` gives it,
layer 0's exact stage one batched `chol_solve` call a side for all S).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from admm_lstm_torch.api import _as_tensor, batch_minor
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.state import (broadcast_state,
                                        penalties_from_vectors)
from admm_lstm_torch.core.step import admm_step_im, rules_for
from admm_lstm_torch.models.lstm import init_lstm_params, train_val_mse_im
from admm_lstm_torch.utils.config import RHO_KEYS, ADMMConfig, ParameterSet
from admm_lstm_torch.utils.device import matmul_precision, resolve_device
from admm_lstm_torch.utils.logging import info, warning


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
        def train_group(lo, hi):
            """Candidates lo..hi-1 from base_state (which the step never
            writes), as one batched program."""
            state = broadcast_state(base_state, hi - lo, penalties_from_vectors(
                candidates[lo:hi], device=device))
            for _ in range(epochs):
                state = admm_step_im(state, x_im, y_im, rules)
            return torch.stack(train_val_mse_im(state.params, xall_im, y_im,
                                                vy_im), dim=-1)

        losses = _train_all('search_rho', candidates, epochs, train_group)
    return _ranked(candidates, losses, base)


def _train_all(name, candidates, epochs, train_group):
    """The (N, 2) train and validation losses of every candidate on the
    host, all N as one batched program through `_run_in_groups`.
    `train_group(lo, hi)` trains candidates lo..hi-1 and returns their
    (hi - lo, 2) losses."""
    n = len(candidates)
    info(f'{name}: {n} candidates x {epochs} epochs in one batched program')
    return _run_in_groups(name, candidates, train_group, 0, n).cpu().numpy()


def _run_in_groups(name, candidates, train_group, lo, hi):
    """`train_group(lo, hi)`; where the card runs out of memory, the
    cached blocks are freed, the group halves and each half runs the same
    way (JAX tune.py:153-178).  A single candidate that does not fit
    raises the CUDA out-of-memory error with a note naming its index."""
    try:
        return train_group(lo, hi)
    except torch.cuda.OutOfMemoryError as e:
        if hi - lo == 1:
            e.add_note(f'{name}: rho candidate {lo} of {len(candidates)} '
                       f'({candidates[lo].tolist()}) ran out of device '
                       f'memory')
            raise
    # Past the except block the failed group's tensors are unreferenced.
    torch.cuda.empty_cache()
    mid = (lo + hi) // 2
    warning(f'{name}: candidates {lo}..{hi - 1} ran out of device memory '
            f'as one group; halving it')
    return torch.cat([_run_in_groups(name, candidates, train_group, lo, mid),
                      _run_in_groups(name, candidates, train_group, mid, hi)])


def _ranked(candidates, losses, base: ParameterSet) -> Dict[str, object]:
    """The search's result: candidates ranked by validation loss (a
    non-finite loss ranks last)."""
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


def search_rho_stacked(train_x, train_y, val_x, val_y, base: ParameterSet,
                       hiddens, config: ADMMConfig = ADMMConfig(),
                       candidates: Optional[np.ndarray] = None,
                       epochs: int = 30,
                       z_candidates: Optional[np.ndarray] = None,
                       params=None, device='cuda') -> Dict[str, object]:
    """`search_rho` for the stacked N-layer variant (JAX tune.py:127-160):
    every candidate trains `epochs` stacked epochs from the same initial
    weights and state, all of them as one batched program on the
    candidate axis (halving where the card runs out of memory).

    z_candidates: optional (N,) values of the stacked variant's rho_z,
    one per candidate; the winner's is folded back into
    'best_parameter_set' and 'best_rho' (and given as 'best_z').
    params: the initial StackedParams (default: `init_stacked` from
    `torch.Generator().manual_seed(config.seed)`).
    """
    from admm_lstm_torch.variants.stacked import (broadcast_stacked_state,
                                                  init_stacked,
                                                  init_stacked_state,
                                                  stacked_admm_step_im,
                                                  stacked_train_val_mse_im)
    if isinstance(base, dict):
        base = ParameterSet.from_dict(base)
    rules = rules_for(config)
    device = resolve_device(device)
    if candidates is None:
        candidates = candidate_grid(base)
    candidates = np.asarray(candidates, np.float32)
    if z_candidates is not None:
        z_candidates = np.asarray(z_candidates, np.float32)
    with matmul_precision(config.matmul_precision):
        train_x, train_y = (_as_tensor(train_x, device),
                            _as_tensor(train_y, device))
        val_x, val_y = _as_tensor(val_x, device), _as_tensor(val_y, device)
        if params is None:
            params = init_stacked(torch.Generator().manual_seed(config.seed),
                                  train_x.shape[2], tuple(hiddens),
                                  train_y.shape[1], device=device)
        base_state = init_stacked_state(params.to(device), train_x, base,
                                        config)
        x_im, y_im, xall_im, vy_im = batch_minor(train_x, train_y, val_x,
                                                 val_y)

        def train_group(lo, hi):
            """Candidates lo..hi-1 from base_state (which the step never
            writes), as one batched program."""
            state = broadcast_stacked_state(
                base_state, hi - lo,
                penalties_from_vectors(candidates[lo:hi], device=device),
                None if z_candidates is None else z_candidates[lo:hi])
            for _ in range(epochs):
                state = stacked_admm_step_im(state, x_im, y_im, rules)
            return torch.stack(stacked_train_val_mse_im(
                state.params, xall_im, y_im, vy_im), dim=-1)

        losses = _train_all('search_rho_stacked', candidates, epochs,
                            train_group)
    out = _ranked(candidates, losses, base)
    if z_candidates is not None:
        out['best_z'] = float(z_candidates[out['order'][0]])
        ps = out['best_parameter_set']
        out['best_parameter_set'] = ParameterSet(
            rho={**ps.rho, 'z': out['best_z']}, beta=dict(ps.beta))
        out['best_rho']['z'] = out['best_z']
    return out


def _refine_loop(search_call, base: ParameterSet, rounds: int,
                 keys: Sequence[str], span: float,
                 points_per_key: int = 5) -> Dict[str, object]:
    """Successive-halving recentering: each round trains a log-grid of
    `points_per_key` (5 or 3) points per key via `search_call(center,
    candidates)`, recenters on the winner, and narrows the per-key span
    by a square root.  The stacked search takes 3 (JAX tune.py:195-223,
    where 5^3 vmapped stacked states did not fit the TPU's memory)."""
    best = base
    result: Dict[str, object] = {}
    history = []
    for r in range(rounds):
        mult = ((1.0 / span, span ** -0.5, 1.0, span ** 0.5, span)
                if points_per_key == 5 else (1.0 / span, 1.0, span))
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


def refine_rho_stacked(train_x, train_y, val_x, val_y, base: ParameterSet,
                       hiddens, config: ADMMConfig = ADMMConfig(),
                       epochs: int = 30, rounds: int = 2,
                       keys: Sequence[str] = ('c', 'h', 'y'),
                       span: float = 10.0, params=None,
                       device='cuda') -> Dict[str, object]:
    """`refine_rho` for the stacked variant (JAX tune.py:241-267): a
    3-point-per-key grid (27 candidates for c, h, y) each round; the
    base tuning's rho_z is re-attached to every round's winner, so the
    returned set trains as the best candidate did."""
    def search_call(best, cands):
        result = search_rho_stacked(train_x, train_y, val_x, val_y, best,
                                    hiddens, config=config,
                                    candidates=cands, epochs=epochs,
                                    params=params, device=device)
        ps = result['best_parameter_set']
        if 'z' in base.rho and 'z' not in ps.rho:
            result['best_parameter_set'] = ParameterSet(
                rho={**ps.rho, 'z': base.rho['z']}, beta=dict(ps.beta))
        return result

    return _refine_loop(search_call, base, rounds, keys, span,
                        points_per_key=3)
