"""The one-epoch ADMM update.

Counterpart of `admm_lstm_tpu/core/step.py` (reference
`ADMMBasedOptimizer.step()`, admm.py:62-78), in the same order:

  1. readout update `wy`, closed form (solvers/closed_form.py says why
     the reference's search is a no-op);
  2. the 8 gate-weight updates as two 4-gate-parallel prox-linear stages
     (x side, then h side) with blocked line searches;
  3. the timestep sweep t = 1..T: the interior steps in Gauss-Seidel
     order, then a peeled final step (prox-linear h, output auxiliary
     `a`, h-dual);
  4. dual ascent for i, f, g, o, c at every t inside the sweep, the
     h-dual at t = T, and the optional y-dual.

On CUDA tensors the interior sweep runs in the hand-written kernel
(kernels/gate_sweep.interior_sweep) whenever `use_pallas_sweep` is True
or 'auto' and T > 1; the JAX package's TPU shape floor for 'auto' does
not carry over.  Otherwise it runs the plain loop below, which mirrors
the JAX package's `lax.scan` body.  The JAX epoch-chunk programs become a
plain Python loop in api.py; the only host syncs inside an epoch are the
line searches of solvers/prox_linear.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from admm_lstm_torch.core.residuals import (admm_residuals_im, balanced_rho,
                                            dual_residuals)
from admm_lstm_torch.core.state import ADMMState, DualSlabs, GateSlabs
from admm_lstm_torch.models.lstm import LSTMParams, train_val_mse_im
from admm_lstm_torch.solvers import closed_form as cf
from admm_lstm_torch.solvers.prox_linear import (h_final_update,
                                                 weight_stage_update_wide)
from admm_lstm_torch.utils.config import ADMMConfig, unsupported_reason

# Gate order i,f,g,o; only g uses tanh.
_IS_TANH = (False, False, True, False)


@dataclasses.dataclass(frozen=True)
class StepRules:
    """Parameters selecting the solver variant (see the JAX package's
    StepRules for the reasoning behind each constant)."""

    with_dual_y: bool = False
    # wy update: final theta and the ridge multiplier in the denominator.
    #   fast      (admm.py:266-280):            theta = 1/2,   beta factor 1
    #   no_dual_y (admm.no_dual_y.py:231-249):  theta = 0.005, beta factor 2
    wy_theta: float = 0.5
    wy_beta_factor: float = 1.0
    # final-h search flavor (see solvers/prox_linear.h_final_update).
    h_grad_uses_rho_h: bool = False
    h_probe_grad_over_theta: bool = False
    h_theta0: float = 0.1
    h_theta_max: float = 1.0
    max_backtrack: int = 60
    # theta = max(wy_theta, rho_y * lambda_max(h^T h)): a true majorizer
    # of the wy objective.  Off by default for reference parity.
    wy_lipschitz: bool = False
    adaptive_rho: bool = False
    adapt_mu: float = 10.0
    adapt_tau: float = 2.0
    # Freeze the adaptation once the epoch count passes this (0 = never).
    adapt_stop_epoch: int = 0
    # True / False / 'auto': True and 'auto' run the CUDA sweep kernel on
    # CUDA tensors whenever T > 1.
    use_pallas_sweep: object = 'auto'


def rules_for(config: ADMMConfig) -> StepRules:
    reason = unsupported_reason(config)
    if reason is not None:
        raise NotImplementedError(reason)
    common = dict(
        h_theta0=config.h_theta0, h_theta_max=config.h_theta_max,
        max_backtrack=config.max_backtrack,
        use_pallas_sweep=config.use_pallas_sweep,
        # Adaptive rho implies the Lipschitz-safeguarded wy step (the
        # reference's fixed theta is only valid while rho_y stays tiny).
        wy_lipschitz=config.wy_lipschitz or config.adaptive_rho,
        adaptive_rho=config.adaptive_rho,
        adapt_mu=config.adapt_mu,
        adapt_tau=config.adapt_tau,
        adapt_stop_epoch=config.adapt_stop_epoch,
    )
    if config.variant == 'no_dual_y':
        return StepRules(with_dual_y=False, wy_theta=0.005, wy_beta_factor=2.0,
                         h_grad_uses_rho_h=True, h_probe_grad_over_theta=True,
                         **common)
    return StepRules(with_dual_y=config.with_dual_y, **common)


def _sweep_uses_kernel(rules: StepRules, seq_len: int,
                       device: torch.device) -> bool:
    return (rules.use_pallas_sweep in (True, 'auto') and seq_len > 1
            and device.type == 'cuda')


def _wy_update(state: ADMMState, rules: StepRules) -> torch.Tensor:
    """Readout update generalized over variant constants (admm.py:246-280)."""
    h_last = state.gates.h[-1]                      # (H, B) batch-minor
    wy = state.params.wy
    resid = torch.einsum('hb,ho->ob', h_last, wy) - state.gates.a
    if rules.with_dual_y:
        resid = resid - state.duals.y / state.rho.y
    grad = state.rho.y * torch.einsum('hb,ob->ho', h_last, resid)
    theta = torch.tensor(rules.wy_theta, dtype=wy.dtype, device=wy.device)
    if rules.wy_lipschitz:
        gram = h_last @ h_last.T
        lip = state.rho.y * torch.linalg.eigvalsh(gram)[-1]
        theta = torch.maximum(theta, lip)
    denom = theta + rules.wy_beta_factor * state.beta.wy
    return (theta * wy - grad) / denom


def _to_wide(w: torch.Tensor) -> torch.Tensor:
    """(4, D, H) -> (D, 4H), gate-major columns."""
    return w.permute(1, 0, 2).reshape(w.shape[1], 4 * w.shape[2])


def _from_wide(w_w: torch.Tensor, hidden: int) -> torch.Tensor:
    """(D, 4H) -> (4, D, H)."""
    return w_w.reshape(w_w.shape[0], 4, hidden).permute(1, 0, 2).contiguous()


def _weight_phase(state: ADMMState, x_im: torch.Tensor,
                  rules: StepRules) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 8 gate-weight updates as two 4-gate-parallel stages, x side then
    h side (the reference's x2g-before-h2g order): the h-side stage sees
    the fresh x-side projection, assembled by linearity.  Gate-folded,
    batch-minor layout: slabs (T, 4H, B), weights (D, 4H)."""
    seq_len = state.seq_len
    hidden = state.hidden_size
    gates, duals, rho = state.gates, state.duals, state.rho
    h_hist = gates.h[:-1]          # (T, H, B) stale history incl. zero row
    rho_g = rho.stacked_ifgo()

    # target = dual/rho + gate per gate (admm.py:309-310), rows t=1..T.
    target_w = torch.cat(
        [d[1:] / r + g[1:] for g, d, r in
         ((gates.i, duals.i, rho.i), (gates.f, duals.f, rho.f),
          (gates.g, duals.g, rho.g), (gates.o, duals.o, rho.o))], dim=1)
    tanh_cols = torch.tensor(_IS_TANH, device=x_im.device).repeat_interleave(
        hidden)

    wx_w, wh_w = _to_wide(state.params.wx), _to_wide(state.params.wh)
    xproj = torch.einsum('tdb,dk->tkb', x_im, wx_w)
    hproj = torch.einsum('tdb,dk->tkb', h_hist, wh_w)

    # Stage X: update x2{i,f,g,o}; hidden-side projection fixed at old wh.
    res_x = weight_stage_update_wide(x_im, xproj, hproj, wx_w, target_w,
                                     rho_g, state.beta.x, tanh_cols, seq_len,
                                     rules.max_backtrack)
    # Stage H: update h2{i,f,g,o}; input-side projection uses FRESH wx.
    res_h = weight_stage_update_wide(h_hist, hproj, res_x.proj_new, wh_w,
                                     target_w, rho_g, state.beta.h, tanh_cols,
                                     seq_len, rules.max_backtrack)
    return _from_wide(res_x.weights, hidden), _from_wide(res_h.weights, hidden)


def _timestep_primal_duals(pre, old, duals_t, c_prev, rho):
    """Interior-timestep math: primal i,f,g,o,c + duals i,f,g,o,c, in the
    reference's in-timestep Gauss-Seidel order (admm.py:345-351).  `pre`
    is the (4, H, B) pre-activation block."""
    _, f_o, g_o, _, c_o, h_o = old
    lam_i, lam_f, lam_g, lam_o, lam_c, lam_h = duals_t
    act_i = torch.sigmoid(pre[0])
    act_f = torch.sigmoid(pre[1])
    act_g = torch.tanh(pre[2])
    act_o = torch.sigmoid(pre[3])

    i_n = cf.gate_ifgo_update(lam_i, rho.i, act_i, g_o, f_o, c_prev,
                              c_o, rho.c, lam_c)
    f_n = cf.gate_ifgo_update(lam_f, rho.f, act_f, c_prev, g_o, i_n,
                              c_o, rho.c, lam_c)
    g_n = cf.gate_ifgo_update(lam_g, rho.g, act_g, i_n, f_n, c_prev,
                              c_o, rho.c, lam_c)
    o_n = cf.gate_ifgo_update(lam_o, rho.o, act_o, torch.tanh(c_o), 0.0, 0.0,
                              h_o, rho.h, lam_h)
    c_n = cf.c_update(c_o, o_n, h_o, lam_h, lam_c, rho.h, rho.c,
                      f_n, c_prev, i_n, g_n)

    lam_n = (cf.dual_ifgo_update(lam_i, rho.i, i_n, act_i),
             cf.dual_ifgo_update(lam_f, rho.f, f_n, act_f),
             cf.dual_ifgo_update(lam_g, rho.g, g_n, act_g),
             cf.dual_ifgo_update(lam_o, rho.o, o_n, act_o),
             cf.dual_c_update(lam_c, rho.c, c_n, f_n, c_prev, i_n, g_n))
    return (i_n, f_n, g_n, o_n, c_n), lam_n


def _sweep(state: ADMMState, x_im: torch.Tensor, params_new: LSTMParams,
           y_im: torch.Tensor, rules: StepRules):
    """The t = 1..T sweep: interior steps (kernel or plain loop), then the
    peeled final step, the `a` update and the duals."""
    rho = state.rho
    seq_len = state.seq_len
    batch = state.batch_size
    hidden = state.hidden_size
    wh = params_new.wh

    # Input-side projections for every t at once: (T, 4, H, B).
    xproj = torch.einsum('tdb,gdh->tghb', x_im, params_new.wx).contiguous()
    gates, duals = state.gates, state.duals
    old_slabs = (gates.i, gates.f, gates.g, gates.o, gates.c, gates.h)
    dual_slabs = (duals.i, duals.f, duals.g, duals.o, duals.c, duals.h)

    def recur_pre(xp_t, h_prev):
        return xp_t + torch.einsum('hb,ghk->gkb', h_prev, wh)

    if _sweep_uses_kernel(rules, seq_len, x_im.device):
        from admm_lstm_torch.kernels.gate_sweep import interior_sweep
        rho_vec = torch.stack([rho.i, rho.f, rho.g, rho.o, rho.c, rho.h])
        new_gates, new_duals = interior_sweep(
            xproj[:seq_len - 1], wh,
            tuple(s[1:seq_len] for s in old_slabs),
            tuple(s[1:seq_len] for s in dual_slabs), rho_vec)
        scanned = new_gates + new_duals
        h_prev, c_prev = scanned[5][-1], scanned[4][-1]
    else:
        # Mirrors the JAX package's lax.scan (core/step.py:357-371,452-456).
        h_prev, c_prev = gates.h[0], gates.c[0]
        rows = [[] for _ in range(11)]
        for t in range(1, seq_len):
            old = tuple(s[t] for s in old_slabs)
            duals_t = tuple(s[t] for s in dual_slabs)
            prim, lam_n = _timestep_primal_duals(
                recur_pre(xproj[t - 1], h_prev), old, duals_t, c_prev, rho)
            h_n = cf.h_interior_update(prim[3], torch.tanh(prim[4]),
                                       duals_t[5], rho.h)
            for acc, v in zip(rows, prim + (h_n,) + lam_n):
                acc.append(v)
            h_prev, c_prev = h_n, prim[4]
        empty = x_im.new_zeros((0, hidden, batch))
        scanned = tuple(torch.stack(r) if r else empty for r in rows)

    # --- Final timestep t = T (admm.py:74-76: gates, then a, then duals). ---
    old_T = tuple(s[seq_len] for s in old_slabs)
    duals_T = tuple(s[seq_len] for s in dual_slabs)
    (i_T, f_T, g_T, o_T, c_T), lam_T = _timestep_primal_duals(
        recur_pre(xproj[seq_len - 1], h_prev), old_T, duals_T, c_prev, rho)
    tanh_c_T = torch.tanh(c_T)
    wy = params_new.wy
    to_out = lambda v: torch.einsum('hb,ho->ob', v, wy)
    from_out = lambda r: torch.einsum('ob,ho->hb', r, wy)
    h_T = h_final_update(
        old_T[5], o_T, tanh_c_T, duals_T[5], rho.h, wy, gates.a, rho.y,
        duals.y, with_dual_y=rules.with_dual_y, theta0=rules.h_theta0,
        theta_max=rules.h_theta_max, max_iters=rules.max_backtrack,
        grad_uses_rho_h=rules.h_grad_uses_rho_h,
        probe_is_grad_over_theta=rules.h_probe_grad_over_theta,
        to_out=to_out, from_out=from_out).h

    a_new = cf.a_update(y_im, to_out(h_T), rho.y, duals.y, batch,
                        rules.with_dual_y)
    lam_h_T = cf.dual_h_update(duals_T[5], rho.h, h_T, o_T, tanh_c_T)

    # --- Reassemble (T+1, H, B) slabs: zero row 0 | interior | final row. ---
    zero_row = x_im.new_zeros((1, hidden, batch))

    def assemble(mid, last):
        return torch.cat([zero_row, mid, last[None]], dim=0)

    i_s, f_s, g_s, o_s, c_s, h_s, li_s, lf_s, lg_s, lo_s, lc_s = scanned
    gates_new = GateSlabs(
        i=assemble(i_s, i_T), f=assemble(f_s, f_T), g=assemble(g_s, g_T),
        o=assemble(o_s, o_T), c=assemble(c_s, c_T), h=assemble(h_s, h_T),
        a=a_new)
    # h-dual rows t < T are never written (admm.py:532-534).
    lam_h_slab = duals.h.clone()
    lam_h_slab[seq_len] = lam_h_T
    lam_T_i, lam_T_f, lam_T_g, lam_T_o, lam_T_c = lam_T
    duals_new = DualSlabs(
        i=assemble(li_s, lam_T_i), f=assemble(lf_s, lam_T_f),
        g=assemble(lg_s, lam_T_g), o=assemble(lo_s, lam_T_o),
        c=assemble(lc_s, lam_T_c), h=lam_h_slab, y=duals.y)
    return gates_new, duals_new


def admm_step(state: ADMMState, train_x: torch.Tensor, train_y: torch.Tensor,
              rules: StepRules) -> ADMMState:
    """One full ADMM epoch: (state, (B,T,I), (B,O)) -> state.

    Faithful to the update ordering of admm.py:62-78:
    wy -> 8 gate weights -> per-t primal/dual sweep (+ a at t=T) -> y-dual.
    """
    x_im = train_x.permute(1, 2, 0).float().contiguous()
    y_im = train_y.T.float().contiguous()
    return admm_step_im(state, x_im, y_im, rules)


def admm_step_im(state: ADMMState, x_im: torch.Tensor, y_im: torch.Tensor,
                 rules: StepRules) -> ADMMState:
    """`admm_step` on batch-minor (T, I, B) inputs and (O, B) targets."""
    # Storage-dtype policy (ADMMConfig.dtype='bfloat16'): slabs are stored
    # at reduced precision, ALL math runs in f32.
    slab_dtype = state.gates.i.dtype
    if slab_dtype != torch.float32:
        state = state._replace(
            gates=GateSlabs(*(s.float() for s in state.gates)),
            duals=DualSlabs(*(s.float() for s in state.duals)))

    wy_new = _wy_update(state, rules)
    state = state._replace(params=state.params._replace(wy=wy_new))

    wx_new, wh_new = _weight_phase(state, x_im, rules)
    params_new = LSTMParams(wx=wx_new, wh=wh_new, wy=wy_new)

    gates_new, duals_new = _sweep(state, x_im, params_new, y_im, rules)

    if rules.with_dual_y:
        hw = torch.einsum('hb,ho->ob', gates_new.h[-1], params_new.wy)
        lam_y = cf.dual_y_update(duals_new.y, state.rho.y, gates_new.a, hw)
        duals_new = duals_new._replace(y=lam_y)

    if slab_dtype != torch.float32:
        gates_new = GateSlabs(*(s.to(slab_dtype) for s in gates_new[:6]),
                              a=gates_new.a)
        duals_new = DualSlabs(*(s.to(slab_dtype) for s in duals_new[:6]),
                              y=duals_new.y)
    new_state = ADMMState(params=params_new, gates=gates_new,
                          duals=duals_new, rho=state.rho, beta=state.beta,
                          epoch=state.epoch + 1)
    live = (not rules.adapt_stop_epoch
            or new_state.epoch <= rules.adapt_stop_epoch)
    if rules.adaptive_rho and live:
        primal = admm_residuals_im(new_state, x_im)
        dual = dual_residuals(new_state, state.gates)
        new_state = new_state._replace(rho=balanced_rho(
            new_state.rho, primal, dual, mu=rules.adapt_mu,
            tau=rules.adapt_tau))
    return new_state


def epoch_step(state: ADMMState, x_im: torch.Tensor, y_im: torch.Tensor,
               xall_im: torch.Tensor, vy_im: torch.Tensor, rules: StepRules,
               with_residuals: bool = False
               ) -> Tuple[ADMMState, Dict[str, torch.Tensor]]:
    """One epoch plus its metrics (train/val loss, optionally residuals),
    all left on the device.  xall_im is the train and validation inputs
    concatenated along the batch axis."""
    prev_gates = state.gates
    state = admm_step_im(state, x_im, y_im, rules)
    train_l, val_l = train_val_mse_im(state.params, xall_im, y_im, vy_im)
    metrics = {'train_loss': train_l, 'val_loss': val_l}
    if with_residuals:
        metrics.update(admm_residuals_im(state, x_im))
        metrics.update(dual_residuals(state, prev_gates))
    return state, metrics


def make_admm_step(config: ADMMConfig):
    """The epoch function for a config (fast / no_dual_y):
    (state, (B,T,I), (B,O)) -> state."""
    rules = rules_for(config)

    def step(state, train_x, train_y):
        return admm_step(state, train_x, train_y, rules)

    return step
