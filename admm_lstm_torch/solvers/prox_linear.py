"""Prox-linear solvers with genuine backtracking line searches.

Counterpart of `admm_lstm_tpu/solvers/prox_linear.py`.  Only two update
families of the fast ADMM variant have data-dependent iteration counts:

* the 8 gate-weight updates (admm.py:282-343), run as two 4-gate-parallel
  stages (input side, then hidden side) whose four independent line
  searches advance in lockstep with per-gate masking;
* the final-timestep h update (admm.py:439-487), a theta-capped search.

The JAX package runs both searches inside `lax.while_loop`s on the
device.  PyTorch runs eagerly, so each loop predicate becomes a host sync:
one per block of BLOCK_K candidates in the weight stage, one per doubling
in the final-h search (at most a handful: theta runs from theta0 to
theta_max by doublings).  These are the only host syncs inside an epoch.
Every search is capped at `max_iters` doublings, with the same
first-acceptance and cap semantics as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Candidate thetas evaluated per host sync of the weight-stage search.
BLOCK_K = 8


class WideStageResult(NamedTuple):
    weights: torch.Tensor   # (D, 4H) updated weights, gate-major columns
    proj_new: torch.Tensor  # (T, 4H, B) m_inputs @ weights (no extra matmul)
    theta: torch.Tensor     # (4,) final (halved) step sizes
    iters: int              # number of doublings the search stepped through


def weight_stage_update_wide(m_inputs: torch.Tensor, proj_self: torch.Tensor,
                             proj_other: torch.Tensor, weights_w: torch.Tensor,
                             target_w: torch.Tensor, rho_g: torch.Tensor,
                             beta_g: torch.Tensor, tanh_cols: torch.Tensor,
                             seq_len: int, max_iters: int) -> WideStageResult:
    """One side (input or hidden) of the gate-weight phase, all 4 gates at
    once, in the gate-folded batch-minor layout: slabs (T, 4H, B), weights
    (D, 4H) with columns ordered gate-major (k = g*H + h), design matrices
    m_inputs (T, D, B).

      grad   = rho * sum_t M_t^T [(act(pre_t) - target_t) * act'(pre_t)]
      search theta: first theta in 1, 2, 4, ... with
          f(W + grad/theta) <= f(W) + (1 + T/2) * |grad|^2 / theta
      theta /= 2
      W_new  = (rho*T*theta/2 * W - grad) / (beta + rho*T*theta/2)

    `proj_self` = m_inputs @ weights_w and `proj_other` is the frozen
    side's projection; `proj_new` is assembled elementwise from them by
    linearity, so the next stage needs no re-projection.
    """
    dtype = weights_w.dtype
    hidden = weights_w.shape[-1] // 4
    rho_cols = torch.repeat_interleave(rho_g, hidden)      # (4H,)
    tanh_b = tanh_cols[:, None]                            # (4H, 1) bool

    # sigmoid(x) = (1 + tanh(x/2)) / 2: both gate families are
    # a + b * tanh(s * x), with derivative c * (1 - u^2) of the same u.
    one, half = torch.tensor(1.0, dtype=dtype), torch.tensor(0.5, dtype=dtype)
    s_cols = torch.where(tanh_b, one, half).to(weights_w.device)
    b_cols = s_cols
    a_cols = torch.where(tanh_b, torch.tensor(0.0, dtype=dtype),
                         half).to(weights_w.device)
    c_cols = torch.where(tanh_b, one,
                         torch.tensor(0.25, dtype=dtype)).to(weights_w.device)

    def act(x):
        return a_cols + b_cols * torch.tanh(s_cols * x)

    def per_gate(v):
        """(4H,) -> (4,) block sums."""
        return v.reshape(4, hidden).sum(-1)

    pre = proj_self + proj_other
    u = torch.tanh(s_cols * pre)
    act_pre, dact_pre = a_cols + b_cols * u, c_cols * (1.0 - u * u)
    resid = act_pre - target_w
    grad = rho_cols * torch.einsum('tdb,tkb->dk', m_inputs, resid * dact_pre)

    f_at_w = 0.5 * rho_g * per_gate(torch.sum(resid * resid, dim=(0, 2)))
    grad_proj = torch.einsum('tdb,dk->tkb', m_inputs, grad)

    # <grad, diff> + T/2 * theta * |diff|^2 with diff = grad/theta
    # collapses to (1 + T/2) * S / theta, S = sum(grad^2) per gate.
    grad_sq = per_gate(torch.sum(grad * grad, dim=0))
    est_coef = (1.0 + 0.5 * seq_len) * grad_sq

    def accept_block(theta_base, k):
        """(4, BLOCK_K) fails table for candidates theta_base * 2^j."""
        fails = []
        for j in range(BLOCK_K):
            th = theta_base * (2.0 ** j)
            th_cols = torch.repeat_interleave(th, hidden)[:, None]
            r = act(pre + grad_proj / th_cols) - target_w
            original = 0.5 * rho_g * per_gate(torch.sum(r * r, dim=(0, 2)))
            fail = original > f_at_w + est_coef / th
            # Candidates past the doubling cap are forced to "fail" so the
            # capped sequential semantics survive blocking.
            fails.append(fail | (k + j >= max_iters))
        return torch.stack(fails, dim=1)

    theta_base = torch.ones(4, dtype=dtype, device=weights_w.device)
    theta_acc = torch.ones_like(theta_base)
    done = torch.zeros(4, dtype=torch.bool, device=weights_w.device)
    k = 0
    while k < max_iters:
        accepts = ~accept_block(theta_base, k)            # (4, BLOCK_K)
        found = accepts.any(dim=1)
        first = torch.argmax(accepts.to(torch.int8), dim=1)  # lowest j
        theta_hit = theta_base * (2.0 ** first.to(dtype))
        theta_acc = torch.where(~done & found, theta_hit, theta_acc)
        done = done | found
        # Unaccepted gates advance by one block, clipped to the doubling
        # budget so a capped gate lands on the sequential loop's last theta.
        step = float(min(BLOCK_K, max_iters - k))
        theta_base = torch.where(done, theta_base, theta_base * (2.0 ** step))
        k += BLOCK_K
        if bool(done.all()):                              # the host sync
            break
    theta = torch.where(done, theta_acc, theta_base) / 2.0

    scale = 0.5 * rho_g * seq_len * theta                 # (4,)
    scale_cols = torch.repeat_interleave(scale, hidden)
    denom_cols = torch.repeat_interleave(beta_g + scale, hidden)
    new_w = (scale_cols * weights_w - grad) / denom_cols
    proj_new = ((scale_cols[:, None] * proj_self - grad_proj)
                / denom_cols[:, None])
    return WideStageResult(weights=new_w, proj_new=proj_new, theta=theta,
                           iters=k)


class HFinalResult(NamedTuple):
    h: torch.Tensor
    theta: torch.Tensor
    iters: int


def h_final_update(h_old, o_new, tanh_c_new, lam_h, rho_h, wy, a_old,
                   rho_y, lam_y, *, with_dual_y: bool, theta0: float,
                   theta_max: float, max_iters: int,
                   grad_uses_rho_h: bool = False,
                   probe_is_grad_over_theta: bool = False,
                   to_out=None, from_out=None) -> HFinalResult:
    """Final-timestep h update: prox-linear on the output-fit term
    (admm.py:439-487; no-dual-y flavor admm.no_dual_y.py:414-449).

      theta = theta0; beta = probe(theta)
      while f(beta) > f(h) + <grad, beta-h> + theta/2*|beta-h|^2:
          theta *= 2; beta = probe(theta)
          if theta >= theta_max: break
      theta /= 2
      h_new = (theta*h + rho_h*o*tanh(c) - lam_h - grad) / (theta + rho_h)

    Flavors: grad_uses_rho_h scales the gradient by rho_h instead of
    rho_y; probe_is_grad_over_theta probes grad/theta instead of the prox
    candidate.  `to_out` (h-like -> output space) and `from_out` default
    to the batch-major (B, H) / (B, O) convention; the epoch passes
    batch-minor closures.
    """
    if to_out is None:
        to_out = lambda v: v @ wy
    if from_out is None:
        from_out = lambda r: r @ wy.T
    dtype = h_old.dtype
    target = a_old
    if with_dual_y:
        target = target + lam_y / rho_y

    hw0 = to_out(h_old)
    resid0 = hw0 - target
    grad = (rho_h if grad_uses_rho_h else rho_y) * from_out(resid0)

    f_at_h = 0.5 * rho_y * torch.sum(resid0 * resid0)
    prox_num_fixed = rho_h * o_new * tanh_c_new - lam_h - grad
    # probe(theta) @ wy is affine in the hoisted products: the loop is
    # matmul-free.
    pnf_wy = to_out(prox_num_fixed)
    grad_wy = to_out(grad)

    def accept_fails(theta):
        if probe_is_grad_over_theta:
            beta, beta_wy = grad / theta, grad_wy / theta
        else:
            beta = (theta * h_old + prox_num_fixed) / (theta + rho_h)
            beta_wy = (theta * hw0 + pnf_wy) / (theta + rho_h)
        r = beta_wy - target
        original = 0.5 * rho_y * torch.sum(r * r)
        diff = beta - h_old
        estimated = (f_at_h + torch.sum(grad * diff)
                     + 0.5 * theta * torch.sum(diff * diff))
        return bool(original > estimated)                 # the host sync

    # theta doubles exactly in f32, so the host keeps its own f32 copy and
    # the stop test needs no sync.
    theta_host = np.float32(theta0)
    theta = torch.tensor(theta_host, dtype=dtype, device=h_old.device)
    k = 0
    while k < max_iters and accept_fails(theta):
        theta_host = np.float32(theta_host * 2)
        theta = theta * 2.0
        k += 1
        if theta_host >= theta_max:
            break
    theta = theta / 2.0

    h_new = (theta * h_old + prox_num_fixed) / (theta + rho_h)
    return HFinalResult(h=h_new, theta=theta, iters=k)
