"""The one-epoch ADMM update.

Counterpart of `admm_lstm_tpu/core/step.py` (reference
`ADMMBasedOptimizer.step()`, admm.py:62-78), in the same order:

  1. readout update `wy`, closed form (solvers/closed_form.py says why
     the reference's search is a no-op);
  2. the 8 gate-weight updates as two 4-gate-parallel stages (x side,
     then h side): prox-linear with blocked line searches, or, under
     `exact_weight_solve`, the exact Gauss-Newton solve of
     solvers/normal_eq.py for each stage whose width D is at most
     `exact_solve_max_dim`;
  3. the timestep sweep t = 1..T: the interior steps in Gauss-Seidel
     order (or, under sweep_mode='jacobi', all at once from the previous
     sweep's h and c), then a peeled final step (prox-linear h, output
     auxiliary `a`, h-dual);
  4. dual ascent for i, f, g, o, c at every t inside the sweep, the
     h-dual at t = T, and the optional y-dual.

On CUDA tensors the interior sweep runs in a hand-written kernel
(kernels/gate_sweep.interior_sweep, or .jacobi_sweep in Jacobi mode)
whenever `use_pallas_sweep` is True or 'auto' and T > 1; the JAX
package's TPU rules for 'auto' (the Gauss-Seidel kernel only at T >= 16,
the Jacobi kernel never) do not carry over.  Otherwise the Gauss-Seidel
sweep runs the plain loop below, which mirrors the JAX package's
`lax.scan` body, and the Jacobi sweep the kernel's plain version.  The
JAX epoch-chunk programs become a plain Python loop (`run_epochs`); the
only host syncs inside an epoch are the line searches of
solvers/prox_linear.py.

Data parallelism (parallel/sharding.py) runs this epoch on each rank's
block of the batch with `StepRules.consensus` set.  Every sum over the
batch is then all-reduced: the readout gradient (with the Gram of h_T
under the Lipschitz step), the weight stages' gradients, objectives and
Gram systems (solvers/prox_linear.py, solvers/normal_eq.py), the final-h
search's sums, the residuals of adaptive rho (core/residuals.py) and the
training loss.  The `a` update scales by the global batch, the local
block times the world.  Nothing else reduces over the batch: the gates,
the duals and `a` are per sample, and the sweep kernels are independent
per batch column, so they run unchanged on the local block.

The time-sharded layout (`StepRules.shard_time`, Jacobi sweep only) runs
it on a contiguous block of the T+1 time rows (core/consensus.time_block)
with the batch whole.  The sums over t are all-reduced over the time
ranks (`consensus`); target row t reads h row t-1, so each rank takes the
old h and c of the row before its block from the previous rank (the
halo).  The last time rank owns row T: it computes wy from h_T, the final
step from the fresh (h, c) at T-1 (a second halo when T-1 lies on the
previous rank), `a` and the y-dual, and broadcasts wy, `a` and the y-dual
to the other time ranks.

Tensor parallelism (`StepRules.model`) runs it on a block of the hidden
axis: the slabs' H rows, the weights' output columns and wy's rows.  Sums
over H (h·wy, the per-gate sums of the weight searches, the final-h
search's norms) are all-reduced over the 'model' ranks; the old h is
gathered to the whole H once an epoch, for the h-stage's design matrix,
the Jacobi recurrence and the Lipschitz Gram.  Each rank updates only its
own columns of the wide weights.  The Gauss-Seidel sweep's serial chain
needs all of h_{t-1} at every step, so under tensor parallelism it runs on
slabs gathered to the whole H on every 'model' rank, each keeping its
block, as the JAX package runs its unsharded kernel on gathered operands.

The candidate axis (core/state.py) runs S independent instances in one
epoch, the JAX package's `vmap` of this epoch written out: every slab,
weight and product carries a leading S axis (`...`-einsums, broadcasting
matmuls, rho viewed as (S, 1, ...) by `_per_candidate`); the data is
shared by the candidates (no leading axis) or per candidate; the line
searches search per candidate with one host read per block for all of
them (solvers/prox_linear.py); the exact weight stage builds each
candidate's Gram systems and solves all S x 4H of them in one batched
solve (solvers/normal_eq.py); either sweep, Gauss-Seidel or Jacobi, is
one launch of its kernel over every candidate.  It takes every config in
one process; `candidate_axis_refusal` names what it does not take (the
sharded layouts, which the JAX package does not vmap either).  A state
without the axis takes the same code with the same numbers as before the
axis existed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from admm_lstm_torch.core.consensus import LOCAL, Consensus, time_block
from admm_lstm_torch.core.residuals import (admm_residuals_im, balanced_rho,
                                            dual_residuals)
from admm_lstm_torch.core.state import (ADMMState, DualSlabs, GateSlabs,
                                        Penalties)
from admm_lstm_torch.kernels import gate_sweep
from admm_lstm_torch.models.lstm import LSTMParams, train_val_mse_im
from admm_lstm_torch.solvers import closed_form as cf
from admm_lstm_torch.solvers.normal_eq import gauss_newton_ridge_update_wide
from admm_lstm_torch.solvers.prox_linear import (h_final_update,
                                                 weight_stage_update_wide)
from admm_lstm_torch.utils.config import ADMMConfig


def gate_is_tanh(n: int, per_gate: int, device) -> torch.Tensor:
    """The (n,) mask of the tanh gate in i, f, g, o order (only g), each
    gate repeated `per_gate` times.  Made on the device: a tensor made on
    the host would be a copy that waits for the stream."""
    return torch.arange(n, device=device) // per_gate == 2


def _per_candidate(rho: Penalties, dims: int) -> Penalties:
    """rho broadcasting over `dims` trailing axes of a candidate: each
    (S,) leaf viewed as (S, 1, ..., 1); 0-d leaves (no candidate axis) as
    they are."""
    return Penalties(*(r.reshape(r.shape + (1,) * dims) if r.dim() else r
                       for r in rho))


def wide_targets(gates: GateSlabs, duals: DualSlabs, rho: Penalties,
                 first: int = 1) -> torch.Tensor:
    """The weight stages' gate targets dual/rho + gate (admm.py:309-310),
    rows t = 1..T, gate-folded: (T, 4H, B).  `first` is the slabs' first
    target row (0 for a time block that starts past row 0)."""
    rho = _per_candidate(rho, 3)
    return torch.cat(
        [d[..., first:, :, :] / r + g[..., first:, :, :] for g, d, r in
         ((gates.i, duals.i, rho.i), (gates.f, duals.f, rho.f),
          (gates.g, duals.g, rho.g), (gates.o, duals.o, rho.o))], dim=-2)


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
    # Geometric dual damping of the stacked variant only: every stacked
    # dual ascent becomes lam <- decay * (lam + rho * resid); 1.0 is
    # exact ADMM (variants/stacked.py).
    stacked_dual_decay: float = 1.0
    # True / False / 'auto': True and 'auto' run the CUDA sweep kernels on
    # CUDA tensors whenever T > 1.
    use_pallas_sweep: object = 'auto'
    # True / False / 'auto': True and 'auto' run the CUDA Cholesky kernels
    # of the exact weight solve on CUDA tensors.
    use_pallas_chol: object = 'auto'
    exact_weight_solve: bool = False
    exact_solve_max_dim: int = 160
    # 'gauss_seidel' = the reference's sequential order; 'jacobi' = every
    # interior timestep from the PREVIOUS sweep's h[t-1], c[t-1] (within a
    # timestep the Gauss-Seidel order i..h is kept).
    sweep_mode: str = 'gauss_seidel'
    # Sets the bf16 rounding of the wide Gram operands (solvers/normal_eq);
    # every other product follows the process-wide matmul precision.
    matmul_precision: str = 'highest'
    # The all-reduce of every sum over the slabs' rows (t, b): over the
    # batch blocks under data parallelism, over the time blocks when
    # shard_time; LOCAL (the identity) in a single process.
    consensus: Consensus = LOCAL
    # The 'model' axis of tensor parallelism: the slabs' H rows, the gate
    # weights' output columns and wy's rows are this rank's block.
    model: Consensus = LOCAL
    # True: `consensus` runs over contiguous blocks of the T+1 time rows
    # and the batch is whole (the time-sharded layout, Jacobi sweep only).
    shard_time: bool = False

    @property
    def batch(self) -> Consensus:
        """The all-reduce of sums over the batch alone: `consensus`, or
        the identity where the batch is whole (time-sharded)."""
        return LOCAL if self.shard_time else self.consensus


def rules_for(config: ADMMConfig) -> StepRules:
    common = dict(
        h_theta0=config.h_theta0, h_theta_max=config.h_theta_max,
        max_backtrack=config.max_backtrack,
        use_pallas_sweep=config.use_pallas_sweep,
        use_pallas_chol=config.use_pallas_chol,
        exact_weight_solve=config.exact_weight_solve,
        exact_solve_max_dim=config.exact_solve_max_dim,
        sweep_mode=config.sweep_mode,
        matmul_precision=config.matmul_precision,
        # Adaptive rho implies the Lipschitz-safeguarded wy step (the
        # reference's fixed theta is only valid while rho_y stays tiny).
        wy_lipschitz=config.wy_lipschitz or config.adaptive_rho,
        adaptive_rho=config.adaptive_rho,
        adapt_mu=config.adapt_mu,
        adapt_tau=config.adapt_tau,
        adapt_stop_epoch=config.adapt_stop_epoch,
        stacked_dual_decay=config.stacked_dual_decay,
    )
    if config.variant == 'no_dual_y':
        return StepRules(with_dual_y=False, wy_theta=0.005, wy_beta_factor=2.0,
                         h_grad_uses_rho_h=True, h_probe_grad_over_theta=True,
                         **common)
    if config.variant == 'fast':
        return StepRules(with_dual_y=config.with_dual_y, **common)
    raise ValueError(f'core.step handles fast/no_dual_y; {config.variant} '
                     f'lives in admm_lstm_torch.variants')


def candidate_axis_refusal(rules: StepRules) -> Optional[str]:
    """Why the epoch does not take the candidate axis under `rules`, or
    None where it does: every config in one process.  The sharded layouts
    refuse it, as the JAX package vmaps no sharded run."""
    if rules.consensus.world > 1 or rules.model.world > 1 or rules.shard_time:
        return 'the candidate axis runs in one process (LOCAL consensus)'
    return None


def _sweep_uses_kernel(rules: StepRules, seq_len: int,
                       device: torch.device) -> bool:
    return (rules.use_pallas_sweep in (True, 'auto') and seq_len > 1
            and device.type == 'cuda')


class _OldRows(NamedTuple):
    """This rank's rows [lo, hi) of the T+1 and the old h and c from row
    max(lo - 1, 0): under time sharding the previous block's last row (the
    halo) stands in front of the block.  `h_full` is that h with the whole
    H (gathered over the 'model' ranks under tensor parallelism)."""
    lo: int
    hi: int
    h: torch.Tensor
    c: torch.Tensor
    h_full: torch.Tensor


def _old_rows(state: ADMMState, seq_len: int, rules: StepRules) -> _OldRows:
    h, c = state.gates.h, state.gates.c
    lo, hi = 0, seq_len + 1
    if rules.shard_time:
        lo, hi = time_block(seq_len + 1, rules.consensus.index,
                            rules.consensus.world)
        if h.shape[0] != hi - lo:
            raise ValueError(f'time block {rules.consensus.index} of '
                             f'{rules.consensus.world} holds rows [{lo}, '
                             f'{hi}) of {seq_len + 1}; the slabs have '
                             f'{h.shape[0]}')
        prev = rules.consensus.halo(torch.stack([h[-1], c[-1]]))
        if prev is not None:
            h, c = torch.cat([prev[0:1], h]), torch.cat([prev[1:2], c])
    return _OldRows(lo, hi, h, c, rules.model.all_gather(h, 1))


def whole_params(params: LSTMParams, model: Consensus) -> LSTMParams:
    """The weights with the whole H: this rank's blocks gathered over the
    'model' ranks (wx, wh on their output columns, wy on its rows)."""
    if model.world == 1:
        return params
    return LSTMParams(wx=model.all_gather(params.wx, 2),
                      wh=model.all_gather(params.wh, 2),
                      wy=model.all_gather(params.wy, 0))


def _wy_update(state: ADMMState, h_last_full: torch.Tensor, last: bool,
               rules: StepRules) -> torch.Tensor:
    """Readout update generalized over variant constants (admm.py:246-280).
    Under time sharding only the last time block holds h_T: it computes
    wy and broadcasts it.  Under tensor parallelism h_T·wy is a partial
    sum over H, and the Lipschitz Gram is of the whole h_T
    (`h_last_full`)."""
    wy = state.params.wy
    rho_y = _per_candidate(state.rho, 2).y
    if last:
        h_last = state.gates.h[..., -1, :, :]       # (H, B) batch-minor
        resid = rules.model.all_sum(
            torch.einsum('...hb,...ho->...ob', h_last, wy)) - state.gates.a
        if rules.with_dual_y:
            resid = resid - state.duals.y / rho_y
        grad_sum = torch.einsum('...hb,...ob->...ho', h_last, resid)
        if rules.wy_lipschitz:
            grad_sum, gram = rules.batch.all_sum_packed(
                grad_sum, h_last_full @ h_last_full.mT)
        else:
            grad_sum = rules.batch.all_sum(grad_sum)
        grad = rho_y * grad_sum
        theta = wy.new_full(state.rho.y.shape, rules.wy_theta)
        if rules.wy_lipschitz:
            lip = state.rho.y * _largest_eigenvalue(gram)
            theta = torch.maximum(theta, lip)
        denom = theta + rules.wy_beta_factor * state.beta.wy
        if theta.dim():                             # (S,) -> (S, 1, 1)
            theta, denom = theta[:, None, None], denom[:, None, None]
        wy = (theta * wy - grad) / denom
    else:
        wy = torch.empty_like(wy)
    if rules.shard_time:
        wy = rules.consensus.broadcast(wy, rules.consensus.world - 1)
    return wy


def _largest_eigenvalue(gram: torch.Tensor) -> torch.Tensor:
    """lambda_max of a symmetric (H, H) Gram, or of each of a batch of
    them; NaN for a Gram that is not finite (a candidate that diverged),
    which is left out of the batched eigensolver, where it could make the
    call raise or spoil the others."""
    if gram.dim() == 2:
        return torch.linalg.eigvalsh(gram)[-1]
    finite = torch.isfinite(gram).all(-1).all(-1)
    top = torch.linalg.eigvalsh(
        torch.where(finite[:, None, None], gram, 0.0))[:, -1]
    return torch.where(finite, top, torch.nan)


def _to_wide(w: torch.Tensor) -> torch.Tensor:
    """(4, D, H) -> (D, 4H), gate-major columns."""
    return w.transpose(-3, -2).reshape(w.shape[:-3]
                                       + (w.shape[-2], 4 * w.shape[-1]))


def _from_wide(w_w: torch.Tensor, hidden: int) -> torch.Tensor:
    """(D, 4H) -> (4, D, H)."""
    return w_w.reshape(w_w.shape[:-1] + (4, hidden)).transpose(
        -3, -2).contiguous()


def _weight_phase(state: ADMMState, x_im: torch.Tensor, old: _OldRows,
                  rules: StepRules) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 8 gate-weight updates as two 4-gate-parallel stages, x side then
    h side (the reference's x2g-before-h2g order): the h-side stage sees
    the fresh x-side projection, assembled by linearity.  Gate-folded,
    batch-minor layout: slabs (T, 4H, B), weights (D, 4H).

    On a block of the rows the targets are the block's rows t >= 1 and the
    design rows are x and h at t-1; on a block of H the wide weights are
    this rank's columns g*H + h of each gate g, and the h-stage's design
    matrix is the old h with the whole H."""
    seq_len = x_im.shape[-3]
    hidden = state.hidden_size
    gates, duals, rho = state.gates, state.duals, state.rho
    h_hist = old.h_full[..., :-1, :, :]   # (T, H, B) stale history, row 0 too
    x_rows = x_im[..., max(old.lo, 1) - 1:old.hi - 1, :, :]
    rho_g = rho.stacked_ifgo()

    target_w = wide_targets(gates, duals, rho, 1 if old.lo == 0 else 0)
    tanh_cols = gate_is_tanh(4 * hidden, hidden, x_im.device)
    # The Gram strategy and the searches see the global shapes.
    total_rows = seq_len * state.batch_size * rules.batch.world
    total_cols = 4 * hidden * rules.model.world

    wx_w, wh_w = _to_wide(state.params.wx), _to_wide(state.params.wh)
    xproj = torch.einsum('...tdb,...dk->...tkb', x_rows, wx_w)
    hproj = torch.einsum('...tdb,...dk->...tkb', h_hist, wh_w)

    def run_stage(m_inputs, proj_self, proj_other, w_w, beta_g, need_proj):
        """-> (new wide weights, fresh self-projection or None).  Under
        exact_weight_solve each stage picks by its own width D (axis -2 of
        m_inputs): exact for D <= exact_solve_max_dim, prox-linear above."""
        if (rules.exact_weight_solve
                and m_inputs.shape[-2] <= rules.exact_solve_max_dim):
            new_w = gauss_newton_ridge_update_wide(
                m_inputs, proj_self + proj_other, w_w, target_w, rho_g,
                beta_g, tanh_cols, rules.matmul_precision,
                use_pallas_chol=rules.use_pallas_chol,
                consensus=rules.consensus, total_rows=total_rows,
                total_cols=total_cols)
            proj_new = (torch.einsum('...tdb,...dk->...tkb', m_inputs, new_w)
                        if need_proj else None)
            return new_w, proj_new
        res = weight_stage_update_wide(m_inputs, proj_self, proj_other, w_w,
                                       target_w, rho_g, beta_g, tanh_cols,
                                       seq_len, rules.max_backtrack,
                                       consensus=rules.consensus,
                                       model=rules.model)
        return res.weights, res.proj_new

    # Stage X: update x2{i,f,g,o}; hidden-side projection fixed at old wh.
    wx_new_w, xproj_new = run_stage(x_rows, xproj, hproj, wx_w, state.beta.x,
                                    need_proj=True)
    # Stage H: update h2{i,f,g,o}; input-side projection uses FRESH wx.
    wh_new_w, _ = run_stage(h_hist, hproj, xproj_new, wh_w, state.beta.h,
                            need_proj=False)
    return _from_wide(wx_new_w, hidden), _from_wide(wh_new_w, hidden)


def _timestep_primal_duals(pre, old, duals_t, c_prev, rho):
    """Interior-timestep math: primal i,f,g,o,c + duals i,f,g,o,c, in the
    reference's in-timestep Gauss-Seidel order (admm.py:345-351).  `pre`
    is the (4, H, B) pre-activation block."""
    _, f_o, g_o, _, c_o, h_o = old
    lam_i, lam_f, lam_g, lam_o, lam_c, lam_h = duals_t
    pre = pre.unbind(-3)
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


def _gauss_seidel(xproj: torch.Tensor, wh: torch.Tensor, old, duals, rho,
                  rho_vec: torch.Tensor, use_kernel: bool):
    """The interior steps t = 1..T-1 in order from h_0 = c_0 = 0: the 11
    new slabs (T-1, H, B), i..h then the duals i..c (each with the leading
    candidate axis of xproj (S, T-1, 4, H, B), if it has one; `rho` viewed
    to broadcast over a candidate's (H, B))."""
    if use_kernel:
        new_gates, new_duals = gate_sweep.interior_sweep(xproj, wh, old,
                                                         duals, rho_vec)
        return new_gates + new_duals
    # Mirrors the JAX package's lax.scan (core/step.py:357-371,452-456).
    steps, _, hidden, batch = xproj.shape[-4:]
    h_prev = xproj.new_zeros(xproj.shape[:-4] + (hidden, batch))
    c_prev = torch.zeros_like(h_prev)
    rows = [[] for _ in range(11)]
    for t in range(steps):
        old_t = tuple(s[..., t, :, :] for s in old)
        duals_t = tuple(s[..., t, :, :] for s in duals)
        pre = xproj[..., t, :, :, :] + torch.einsum('...hb,...ghk->...gkb',
                                                    h_prev, wh)
        prim, lam_n = _timestep_primal_duals(pre, old_t, duals_t, c_prev, rho)
        h_n = cf.h_interior_update(prim[3], torch.tanh(prim[4]), duals_t[5],
                                   rho.h)
        for acc, v in zip(rows, prim + (h_n,) + lam_n):
            acc.append(v)
        h_prev, c_prev = h_n, prim[4]
    empty = xproj.new_zeros(xproj.shape[:-4] + (0, hidden, batch))
    return tuple(torch.stack(r, dim=-3) if r else empty for r in rows)


def _sweep(state: ADMMState, x_im: torch.Tensor, params_new: LSTMParams,
           y_im: torch.Tensor, old: _OldRows, rules: StepRules):
    """The t = 1..T sweep: this rank's interior steps (kernel or plain
    loop), then, on the rank that holds row T, the peeled final step, the
    `a` update and the duals (the y-dual too)."""
    rho = _per_candidate(state.rho, 2)      # over (H, B) or (O, B)
    seq_len = x_im.shape[-3]
    batch = state.batch_size
    hidden = state.hidden_size
    lead = state.gates.a.shape[:-2]         # (S,) with the candidate axis
    wh = params_new.wh
    lo, hi = old.lo, old.hi
    last = hi == seq_len + 1
    t0, t1 = max(lo, 1), min(hi, seq_len)     # this block's interior rows
    n_int = max(t1 - t0, 0)

    # Input-side projections of rows t0..t1-1 and, on the last block, T:
    # (n_int + last, 4, H, B).
    xproj = torch.einsum('...tdb,...gdh->...tghb',
                         x_im[..., t0 - 1:t1 - 1 + last, :, :],
                         params_new.wx).contiguous()
    gates, duals = state.gates, state.duals
    old_slabs = (gates.i, gates.f, gates.g, gates.o, gates.c, gates.h)
    dual_slabs = (duals.i, duals.f, duals.g, duals.o, duals.c, duals.h)
    r = state.rho
    rho_vec = torch.stack([r.i, r.f, r.g, r.o, r.c, r.h], dim=-1)
    interior = lambda slabs: tuple(s[..., t0 - lo:t1 - lo, :, :]
                                   for s in slabs)
    use_kernel = _sweep_uses_kernel(rules, seq_len, x_im.device)
    empty = x_im.new_zeros(lead + (0, hidden, batch))
    h_prev_full = None          # the fresh h at T-1 with the whole H
    if rules.sweep_mode == 'jacobi' and seq_len > 1:
        # Every interior timestep reads the PREVIOUS sweep's h[t-1] and
        # c[t-1]: the recurrent projection of all of them is one product,
        # and the rest is one elementwise pass (JAX core/step.py:374-430).
        scanned = (empty,) * 11
        if n_int:
            # (4H, H_in) against each row's h; with the candidate axis one
            # product per candidate, broadcast over its rows.
            w_rec = _to_wide(wh).mT
            if lead:
                w_rec = w_rec.unsqueeze(-3)
            rec = torch.matmul(w_rec, old.h_full[..., :n_int, :, :])
            pre_all = xproj[..., :n_int, :, :, :] + rec.reshape(
                lead + (n_int, 4, hidden, batch))
            sweep = (gate_sweep.jacobi_sweep if use_kernel
                     else gate_sweep.jacobi_sweep_plain)
            new_gates, new_duals = sweep(
                pre_all, interior(old_slabs), interior(dual_slabs),
                old.h[..., :n_int, :, :], old.c[..., :n_int, :, :], rho_vec)
            scanned = new_gates + new_duals
    elif rules.model.world > 1:
        # The serial chain needs all of h_{t-1} at every step: every
        # 'model' rank sweeps the slabs gathered to the whole H and keeps
        # its block.
        model = rules.model
        wx_full, wh_full = (model.all_gather(w, 2)
                            for w in (params_new.wx, wh))
        slabs = model.all_gather(torch.stack(interior(old_slabs)
                                             + interior(dual_slabs)), 2)
        xproj_full = torch.einsum('tdb,gdh->tghb', x_im[:seq_len - 1],
                                  wx_full).contiguous()
        scanned_full = _gauss_seidel(xproj_full, wh_full, slabs[:6].unbind(),
                                     slabs[6:].unbind(), rho, rho_vec,
                                     use_kernel)
        h0 = model.index * hidden
        scanned = tuple(s[:, h0:h0 + hidden].contiguous()
                        for s in scanned_full)
        if n_int:
            h_prev_full = scanned_full[5][-1]
    else:
        scanned = _gauss_seidel(xproj[..., :n_int, :, :, :], wh,
                                interior(old_slabs), interior(dual_slabs),
                                rho, rho_vec, use_kernel)

    # The fresh (h, c) at T-1 for the final step: the block's last interior
    # row, the previous block's (a second halo) when row T is the last
    # block's only row, or row 0's zeros when T = 1.
    fresh = None
    world = rules.consensus.world
    if (rules.shard_time
            and time_block(seq_len + 1, world - 1, world)[0] == seq_len):
        mine = (torch.stack([scanned[5][-1], scanned[4][-1]]) if n_int
                else x_im.new_zeros((2, hidden, batch)))
        fresh = rules.consensus.halo(mine)

    a_new, lam_y = torch.empty_like(gates.a), duals.y
    if last:
        # --- Final timestep t = T (admm.py:74-76: gates, a, duals). ---
        if n_int:
            h_prev = scanned[5][..., -1, :, :]
            c_prev = scanned[4][..., -1, :, :]
        elif fresh is not None:
            h_prev, c_prev = fresh[0], fresh[1]
        else:
            h_prev = c_prev = x_im.new_zeros(lead + (hidden, batch))
        if h_prev_full is None:
            h_prev_full = rules.model.all_gather(h_prev, 0)
        old_T = tuple(s[..., -1, :, :] for s in old_slabs)
        duals_T = tuple(s[..., -1, :, :] for s in dual_slabs)
        pre_T = xproj[..., -1, :, :, :] + torch.einsum(
            '...hb,...ghk->...gkb', h_prev_full, wh)
        (i_T, f_T, g_T, o_T, c_T), lam_T = _timestep_primal_duals(
            pre_T, old_T, duals_T, c_prev, rho)
        tanh_c_T = torch.tanh(c_T)
        wy = params_new.wy
        to_out = lambda v: rules.model.all_sum(
            torch.einsum('...hb,...ho->...ob', v, wy))
        from_out = lambda r: torch.einsum('...ob,...ho->...hb', r, wy)
        h_T = h_final_update(
            old_T[5], o_T, tanh_c_T, duals_T[5], rho.h, wy, gates.a, rho.y,
            duals.y, with_dual_y=rules.with_dual_y, theta0=rules.h_theta0,
            theta_max=rules.h_theta_max, max_iters=rules.max_backtrack,
            grad_uses_rho_h=rules.h_grad_uses_rho_h,
            probe_is_grad_over_theta=rules.h_probe_grad_over_theta,
            to_out=to_out, from_out=from_out, consensus=rules.batch,
            model=rules.model).h

        # The a update scales by the whole (padded) batch, as the JAX
        # package does under the mesh: the batch blocks are equal, so the
        # local block times their number.
        hw_T = to_out(h_T)
        a_new = cf.a_update(y_im, hw_T, rho.y, duals.y,
                            batch * rules.batch.world, rules.with_dual_y)
        lam_h_T = cf.dual_h_update(duals_T[5], rho.h, h_T, o_T, tanh_c_T)
        if rules.with_dual_y:
            lam_y = cf.dual_y_update(duals.y, rho.y, a_new, hw_T)
    if rules.shard_time:
        # `a` and the y-dual stay replicated: the last block sends them.
        src = world - 1
        if rules.with_dual_y:
            a_new, lam_y = rules.consensus.broadcast(
                torch.stack([a_new, lam_y]), src).unbind()
        else:
            a_new = rules.consensus.broadcast(a_new.contiguous(), src)

    # --- Reassemble the block's slabs: zero row 0 | interior | row T. ---
    zero_row = x_im.new_zeros(lead + (1, hidden, batch))

    def assemble(mid, last_row):
        return torch.cat(([zero_row] if lo == 0 else []) + [mid]
                         + ([last_row.unsqueeze(-3)] if last else []),
                         dim=-3)

    if not last:
        i_T = f_T = g_T = o_T = c_T = h_T = None
        lam_T = (None,) * 5
    i_s, f_s, g_s, o_s, c_s, h_s, li_s, lf_s, lg_s, lo_s, lc_s = scanned
    gates_new = GateSlabs(
        i=assemble(i_s, i_T), f=assemble(f_s, f_T), g=assemble(g_s, g_T),
        o=assemble(o_s, o_T), c=assemble(c_s, c_T), h=assemble(h_s, h_T),
        a=a_new)
    # h-dual rows t < T are never written (admm.py:532-534).
    lam_h_slab = duals.h.clone()
    if last:
        lam_h_slab[..., -1, :, :] = lam_h_T
    lam_T_i, lam_T_f, lam_T_g, lam_T_o, lam_T_c = lam_T
    duals_new = DualSlabs(
        i=assemble(li_s, lam_T_i), f=assemble(lf_s, lam_T_f),
        g=assemble(lg_s, lam_T_g), o=assemble(lo_s, lam_T_o),
        c=assemble(lc_s, lam_T_c), h=lam_h_slab, y=lam_y)
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
    """`admm_step` on batch-minor (T, I, B) inputs and (O, B) targets
    (this rank's block of the batch under data parallelism, whole under
    time sharding).  A state with the candidate axis takes inputs and
    targets shared by its candidates or with a leading S axis of their
    own, under rules that `candidate_axis_refusal` accepts."""
    if state.candidates is not None:
        refusal = candidate_axis_refusal(rules)
        if refusal:
            raise ValueError(f'a state with the candidate axis: {refusal}')
    # Storage-dtype policy (ADMMConfig.dtype='bfloat16'): slabs are stored
    # at reduced precision, ALL math runs in f32.
    slab_dtype = state.gates.i.dtype
    if slab_dtype != torch.float32:
        state = state._replace(
            gates=GateSlabs(*(s.float() for s in state.gates)),
            duals=DualSlabs(*(s.float() for s in state.duals)))

    seq_len = x_im.shape[-3]
    old = _old_rows(state, seq_len, rules)
    wy_new = _wy_update(state, old.h_full[..., -1, :, :],
                        old.hi == seq_len + 1, rules)
    state = state._replace(params=state.params._replace(wy=wy_new))

    wx_new, wh_new = _weight_phase(state, x_im, old, rules)
    params_new = LSTMParams(wx=wx_new, wh=wh_new, wy=wy_new)

    gates_new, duals_new = _sweep(state, x_im, params_new, y_im, old, rules)

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
        primal = admm_residuals_im(new_state, x_im, rules)
        dual = dual_residuals(new_state, state.gates, rules, seq_len)
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
    concatenated along the batch axis.  The losses come from one forward
    of the weights with the whole H over the inputs, which are whole on
    every rank but for data parallelism's blocks of the batch."""
    prev_gates = state.gates
    state = admm_step_im(state, x_im, y_im, rules)
    train_l, val_l = train_val_mse_im(whole_params(state.params, rules.model),
                                      xall_im, y_im, vy_im, rules.batch)
    metrics = {'train_loss': train_l, 'val_loss': val_l}
    if with_residuals:
        metrics.update(admm_residuals_im(state, x_im, rules))
        metrics.update(dual_residuals(state, prev_gates, rules,
                                      x_im.shape[-3]))
    return state, metrics


def run_epochs(state: ADMMState, num_epochs: int, x_im: torch.Tensor,
               y_im: torch.Tensor, xall_im: torch.Tensor, vy_im: torch.Tensor,
               rules: StepRules, with_residuals: bool = False, best=None
               ) -> Tuple[ADMMState, Dict[str, torch.Tensor]]:
    """`num_epochs` epochs of `epoch_step`; returns the state and each
    metric's (num_epochs,) trajectory, on the device.  `best`, a dict
    {'val': 0-d tensor, 'params': LSTMParams}, is the best-validation
    carry, updated in place on the device after every epoch."""
    hist = []
    for _ in range(num_epochs):
        state, metrics = epoch_step(state, x_im, y_im, xall_im, vy_im, rules,
                                    with_residuals=with_residuals)
        hist.append(metrics)
        if best is not None:
            # NaN-safe on the device: NaN < best is False.
            better = metrics['val_loss'] < best['val']
            best['val'] = torch.where(better, metrics['val_loss'],
                                      best['val'])
            best['params'] = LSTMParams(*(
                torch.where(better, new, old)
                for new, old in zip(state.params, best['params'])))
    return state, {k: torch.stack([m[k] for m in hist]) for k in hist[0]}


def make_admm_step(config: ADMMConfig):
    """The epoch function for a config (fast / no_dual_y):
    (state, (B,T,I), (B,O)) -> state."""
    rules = rules_for(config)

    def step(state, train_x, train_y):
        return admm_step(state, train_x, train_y, rules)

    return step
