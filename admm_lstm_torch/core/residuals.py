"""Primal/dual residual monitoring and residual-balancing rho adaptation.

Counterpart of `admm_lstm_tpu/core/residuals.py`:
  * `admm_residuals_im(state, x_im)` - RMS primal violation per
    constraint family;
  * `dual_residuals(state, old_gates)` - rho * RMS change of each primal
    block between sweeps (Boyd et al. 2011, eq. 3.12);
  * `balanced_rho` - residual balancing (Boyd et al. 2011, section 3.4.1).
All results are 0-d tensors on the state's device (no host sync).
"""

from __future__ import annotations

from typing import Dict

import torch

from admm_lstm_torch.core.state import ADMMState, GateSlabs, Penalties

_FAMILIES = ('i', 'f', 'g', 'o', 'c', 'h', 'y')


def _rms(x: torch.Tensor) -> torch.Tensor:
    x = x.float()  # accumulate in f32 under bf16 slab storage
    return torch.sqrt(torch.mean(x * x))


def admm_residuals(state: ADMMState,
                   train_x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RMS primal residuals on (B, T, I) inputs."""
    return admm_residuals_im(state, train_x.permute(1, 2, 0))


def admm_residuals_im(state: ADMMState,
                      x_im: torch.Tensor) -> Dict[str, torch.Tensor]:
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
    res = {}
    for k, now, act in zip(('i', 'f', 'g', 'o'), gates_now, acts):
        res[f'r_{k}'] = _rms(now - act)
    res['r_c'] = _rms(g.c[1:] - (g.f[1:] * g.c[:-1] + g.i[1:] * g.g[1:]))
    res['r_h'] = _rms(g.h[1:] - g.o[1:] * torch.tanh(g.c[1:]))
    res['r_y'] = _rms(g.a - torch.einsum('hb,ho->ob', g.h[-1].to(p.wy.dtype),
                                         p.wy))
    return res


def dual_residuals(state: ADMMState,
                   prev_gates: GateSlabs) -> Dict[str, torch.Tensor]:
    """RMS dual residuals: rho_k * ||primal_k^new - primal_k^old||_RMS."""
    g, r = state.gates, state.rho
    out = {}
    for k in ('i', 'f', 'g', 'o', 'c', 'h'):
        out[f's_{k}'] = getattr(r, k) * _rms(getattr(g, k)
                                             - getattr(prev_gates, k))
    out['s_y'] = r.y * _rms(g.a - prev_gates.a)
    return out


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
