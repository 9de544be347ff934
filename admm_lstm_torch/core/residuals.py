"""Primal/dual residual monitoring and residual-balancing rho adaptation.

Counterpart of `admm_lstm_tpu/core/residuals.py`:
  * `admm_residuals_im(state, x_im)` - RMS primal violation per
    constraint family;
  * `dual_residuals(state, old_gates)` - rho * RMS change of each primal
    block between sweeps (Boyd et al. 2011, eq. 3.12);
  * `balanced_rho` - residual balancing (Boyd et al. 2011, section 3.4.1).
All results are 0-d tensors on the state's device (no host sync).

Under data parallelism (core/consensus.py) each mean square is a global
one: every rank's means over its equal block of the batch are averaged in
one all-reduce per call, so every rank sees the single-process residuals
and adapts rho the same way.
"""

from __future__ import annotations

from typing import Dict

import torch

from admm_lstm_torch.core.consensus import LOCAL, Consensus
from admm_lstm_torch.core.state import ADMMState, GateSlabs, Penalties

_FAMILIES = ('i', 'f', 'g', 'o', 'c', 'h', 'y')


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    x = x.float()  # accumulate in f32 under bf16 slab storage
    return torch.mean(x * x)


def _rms(named: Dict[str, torch.Tensor],
         consensus: Consensus) -> Dict[str, torch.Tensor]:
    """{name: RMS of the tensor over the whole batch}, one all-reduce."""
    means = consensus.means([_mean_square(x) for x in named.values()])
    return {k: torch.sqrt(m) for k, m in zip(named, means)}


def admm_residuals(state: ADMMState,
                   train_x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RMS primal residuals on (B, T, I) inputs."""
    return admm_residuals_im(state, train_x.permute(1, 2, 0))


def admm_residuals_im(state: ADMMState, x_im: torch.Tensor,
                      consensus: Consensus = LOCAL
                      ) -> Dict[str, torch.Tensor]:
    """RMS primal residuals of each constraint family, on batch-minor
    (T, I, B) inputs.

      gate_g[t] = act(x_t Wx_g + h_{t-1} Wh_g)   for g in i,f,g,o
      c[t]      = f[t]*c[t-1] + i[t]*g[t]
      h[t]      = o[t]*tanh(c[t])
      a         = h_T @ wy
    """
    g = state.gates
    p = state.params
    h_prev = g.h[:-1]
    pre = (torch.einsum('tdb,gdh->gthb', x_im, p.wx)
           + torch.einsum('tub,guh->gthb', h_prev.to(p.wh.dtype), p.wh))
    acts = (torch.sigmoid(pre[0]), torch.sigmoid(pre[1]),
            torch.tanh(pre[2]), torch.sigmoid(pre[3]))
    gates_now = (g.i[1:], g.f[1:], g.g[1:], g.o[1:])
    diffs = {f'r_{k}': now - act
             for k, now, act in zip(('i', 'f', 'g', 'o'), gates_now, acts)}
    diffs['r_c'] = g.c[1:] - (g.f[1:] * g.c[:-1] + g.i[1:] * g.g[1:])
    diffs['r_h'] = g.h[1:] - g.o[1:] * torch.tanh(g.c[1:])
    diffs['r_y'] = g.a - torch.einsum('hb,ho->ob', g.h[-1].to(p.wy.dtype),
                                      p.wy)
    return _rms(diffs, consensus)


def dual_residuals(state: ADMMState, prev_gates: GateSlabs,
                   consensus: Consensus = LOCAL) -> Dict[str, torch.Tensor]:
    """RMS dual residuals: rho_k * ||primal_k^new - primal_k^old||_RMS."""
    g, r = state.gates, state.rho
    diffs = {k: getattr(g, k) - getattr(prev_gates, k)
             for k in ('i', 'f', 'g', 'o', 'c', 'h')}
    diffs['y'] = g.a - prev_gates.a
    rms = _rms(diffs, consensus)
    return {f's_{k}': getattr(r, k) * rms[k] for k in _FAMILIES}


def balanced_rho(rho: Penalties, primal: Dict[str, torch.Tensor],
                 dual: Dict[str, torch.Tensor], mu: float = 10.0,
                 tau: float = 2.0, rho_min: float = 1e-9,
                 rho_max: float = 1e3) -> Penalties:
    """Per family: rho *= tau when the primal residual exceeds mu x the
    dual residual, rho /= tau in the reverse case; clipped to
    [rho_min, rho_max]."""
    new = {}
    for k in _FAMILIES:
        v = getattr(rho, k)
        r, s = primal[f'r_{k}'], dual[f's_{k}']
        v_new = torch.where(r > mu * s, v * tau,
                            torch.where(s > mu * r, v / tau, v))
        new[k] = torch.clamp(v_new, rho_min, rho_max)
    return Penalties(**new)
