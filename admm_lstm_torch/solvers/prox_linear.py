"""Prox-linear solvers with genuine backtracking line searches.

Counterpart of `admm_lstm_tpu/solvers/prox_linear.py`.  Only two update
families of the fast ADMM variant have data-dependent iteration counts:

* the 8 gate-weight updates (admm.py:282-343), run as two 4-gate-parallel
  stages (input side, then hidden side) whose four independent line
  searches advance in lockstep with per-gate masking;
* the final-timestep h update (admm.py:439-487), a theta-capped search.

The JAX package runs both searches inside `lax.while_loop`s on the
device.  PyTorch runs eagerly, so each loop predicate becomes a host sync:
one per block of BLOCK_K candidates in the weight stage
(`doubling_search`, which ADMM-LSTM-L's three searches use too), one per
doubling in the final-h search (at most a handful: theta runs from theta0
to theta_max by doublings).  These are the only host syncs inside an
epoch.  Every search is capped at `max_iters` doublings, with the same
first-acceptance and cap semantics as the JAX package.

Under data parallelism (core/consensus.py) every objective sum of a line
search is all-reduced before it is compared, so that every rank takes the
same branch and makes the same number of host reads: in the weight stage
the gradient and f(W) in one packed all-reduce, then each block's (K, 4)
table of candidate objectives in one; in the final-h search f(h), then
the three sums of each acceptance test in one packed all-reduce.  Under
tensor parallelism (`model`) a rank holds only its columns of each gate,
so the per-gate sums of the weight stage and the final-h search's sums
over H are all-reduced over the 'model' ranks as well, and every rank
takes the same theta.

With the candidate axis (core/state.py; one process only) each of the S
instances searches on its own, as under the JAX package's `vmap` of the
masked loops: the weight stage's thetas are (S, 4) and one host read per
block covers all S x 4 of them; the final-h search's theta is (S,), a
`doubling_search` over the doublings that the host counts in f32
(`final_h_tests`), so each candidate takes the theta of its run alone,
untested cap included, with one host read per block of BLOCK_K.  A
candidate whose sums are NaN accepts at once (NaN > x is False) and never
holds the others in a loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from admm_lstm_torch.core.consensus import LOCAL, Consensus

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
                             seq_len: int, max_iters: int,
                             consensus: Consensus = LOCAL,
                             model: Consensus = LOCAL) -> WideStageResult:
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
    linearity, so the next stage needs no re-projection.  `seq_len` is
    the global T, whatever rows this rank holds; `model` all-reduces the
    per-gate sums over the ranks that hold the other columns.

    Candidate axis: slabs (S, T, 4H, B), weights (S, D, 4H), rho_g and
    beta_g (S, 4), theta (S, 4); m_inputs (T, D, B) may be shared by the
    candidates (the x side on shared data).
    """
    dtype = weights_w.dtype
    hidden = weights_w.shape[-1] // 4

    def per_gate(v):
        """(..., 4H) -> (..., 4) block sums."""
        return v.reshape(v.shape[:-1] + (4, hidden)).sum(-1)

    def cols(v):
        """(..., 4) per gate -> (..., 4H) per column."""
        return torch.repeat_interleave(v, hidden, dim=-1)

    rho_cols = cols(rho_g)                                 # (4H,)
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


    pre = proj_self + proj_other
    u = torch.tanh(s_cols * pre)
    act_pre, dact_pre = a_cols + b_cols * u, c_cols * (1.0 - u * u)
    resid = act_pre - target_w
    grad_sum, sq_cols = consensus.all_sum_packed(
        torch.einsum('...tdb,...tkb->...dk', m_inputs, resid * dact_pre),
        torch.sum(resid * resid, dim=(-3, -1)))
    grad = rho_cols.unsqueeze(-2) * grad_sum
    grad_proj = torch.einsum('...tdb,...dk->...tkb', m_inputs, grad)

    # <grad, diff> + T/2 * theta * |diff|^2 with diff = grad/theta
    # collapses to (1 + T/2) * S / theta, S = sum(grad^2) per gate.
    sq_gate, grad_sq = model.all_sum_packed(
        per_gate(sq_cols), per_gate(torch.sum(grad * grad, dim=-2)))
    f_at_w = 0.5 * rho_g * sq_gate
    est_coef = (1.0 + 0.5 * seq_len) * grad_sq

    def fails(cands):
        """(K, [S,] 4) candidate thetas -> the table of those that fail."""
        sums = []
        for th in cands:
            th_cols = cols(th)[..., None].unsqueeze(-3)   # ([S,] 1, 4H, 1)
            r = act(pre + grad_proj / th_cols) - target_w
            sums.append(per_gate(torch.sum(r * r, dim=(-3, -1))))
        original = 0.5 * rho_g * model.all_sum(
            consensus.all_sum(torch.stack(sums)))
        return original > f_at_w + est_coef / cands

    theta, iters = doubling_search(
        fails, torch.ones(rho_g.shape, dtype=dtype, device=weights_w.device),
        max_iters)
    theta = theta / 2.0

    scale = 0.5 * rho_g * seq_len * theta                 # (4,)
    scale_cols, denom_cols = cols(scale), cols(beta_g + scale)
    new_w = ((scale_cols.unsqueeze(-2) * weights_w - grad)
             / denom_cols.unsqueeze(-2))
    proj_new = ((scale_cols[..., None].unsqueeze(-3) * proj_self - grad_proj)
                / denom_cols[..., None].unsqueeze(-3))
    return WideStageResult(weights=new_w, proj_new=proj_new, theta=theta,
                           iters=iters)


def doubling_search(fails, theta0: torch.Tensor, max_iters: int):
    """theta0 * 2^k for the first k in 0 .. max_iters - 1 at which
    `fails` accepts, entry by entry of theta0 (the entries search
    independently, as the JAX package's lockstep loops do); where none is
    accepted, theta0 * 2^max_iters, untested.  That is what
    `while fails(theta) and k < max_iters: theta *= 2` returns.

    `fails(cands)` takes a (K, *theta0.shape) block of candidates and
    returns the bool table of those that fail.  BLOCK_K candidates are
    tested per host sync; every candidate is theta0 times a power of two
    and so exact.  Returns (theta, iters), iters = BLOCK_K times the
    blocks tested (the JAX package's blocked weight stage counts so).
    """
    view = (-1,) + (1,) * theta0.dim()
    pow2 = theta0.new_full((BLOCK_K,), 2.0).cumprod(0) / 2.0   # 1, 2, 4...
    base = theta0
    theta = theta0 * (2.0 ** max_iters)
    done = torch.zeros(theta0.shape, dtype=torch.bool, device=theta0.device)
    k = 0
    while k < max_iters:
        n = min(BLOCK_K, max_iters - k)
        cands = base * pow2[:n].view(view)
        accepts = ~fails(cands)
        found = accepts.any(dim=0)
        first = torch.argmax(accepts.to(torch.int8), dim=0)   # lowest k
        hit = cands.gather(0, first.unsqueeze(0)).squeeze(0)
        theta = torch.where(~done & found, hit, theta)
        done = done | found
        k += BLOCK_K
        if bool(done.all()):                                 # the host sync
            break
        base = base * (2.0 ** n)
    return theta, k


def final_h_tests(theta0: float, theta_max: float, max_iters: int) -> int:
    """How many thetas the final-h search tests when every test fails:
    theta0 * 2^k for k < n, n = min(max_iters, the doublings from theta0
    to the first theta >= theta_max), counted in f32 as the loop doubles
    (at least one doubling, so theta0 >= theta_max gives n = 1)."""
    theta, n = np.float32(theta0), 0
    while n < max_iters:
        n += 1
        theta = np.float32(theta * 2)
        if theta >= theta_max:
            break
    return n


class HFinalResult(NamedTuple):
    h: torch.Tensor
    theta: torch.Tensor
    iters: int


def h_final_update(h_old, o_new, tanh_c_new, lam_h, rho_h, wy, a_old,
                   rho_y, lam_y, *, with_dual_y: bool, theta0: float,
                   theta_max: float, max_iters: int,
                   grad_uses_rho_h: bool = False,
                   probe_is_grad_over_theta: bool = False,
                   to_out=None, from_out=None,
                   consensus: Consensus = LOCAL,
                   model: Consensus = LOCAL) -> HFinalResult:
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
    batch-minor closures.  Under tensor parallelism `to_out` all-reduces
    its partial sum over H, and `model` the search's sums over H.

    Candidate axis: h-like (S, H, B), rho_h and rho_y as (S, 1, 1) views,
    theta (S,), searched by `doubling_search` over `final_h_tests`
    thetas, the loop's own, so each candidate takes its theta alone.
    """
    if to_out is None:
        to_out = lambda v: v @ wy
    if from_out is None:
        from_out = lambda r: r @ wy.T
    dtype = h_old.dtype
    batched = h_old.dim() == 3
    if batched:      # each candidate's sums, kept to broadcast over its slab
        total = lambda v: torch.sum(v, dim=(-2, -1), keepdim=True)
    else:
        total = torch.sum
    target = a_old
    if with_dual_y:
        target = target + lam_y / rho_y

    hw0 = to_out(h_old)
    resid0 = hw0 - target
    grad = (rho_h if grad_uses_rho_h else rho_y) * from_out(resid0)

    f_at_h = 0.5 * rho_y * consensus.all_sum(total(resid0 * resid0))
    prox_num_fixed = rho_h * o_new * tanh_c_new - lam_h - grad
    # probe(theta) @ wy is affine in the hoisted products: the loop is
    # matmul-free.
    pnf_wy = to_out(prox_num_fixed)
    grad_wy = to_out(grad)

    def fails(theta):
        if probe_is_grad_over_theta:
            beta, beta_wy = grad / theta, grad_wy / theta
        else:
            beta = (theta * h_old + prox_num_fixed) / (theta + rho_h)
            beta_wy = (theta * hw0 + pnf_wy) / (theta + rho_h)
        r = beta_wy - target
        diff = beta - h_old
        cross, sq_diff = model.all_sum_packed(total(grad * diff),
                                              total(diff * diff))
        sq_r, cross, sq_diff = consensus.all_sum_packed(total(r * r),
                                                        cross, sq_diff)
        original = 0.5 * rho_y * sq_r
        estimated = f_at_h + cross + 0.5 * theta * sq_diff
        return original > estimated

    if batched:
        theta, k = doubling_search(
            lambda cands: torch.stack([fails(th) for th in cands]),
            h_old.new_full(h_old.shape[:-2] + (1, 1),
                           float(np.float32(theta0))),
            final_h_tests(theta0, theta_max, max_iters))
        theta = theta / 2.0
        h_new = (theta * h_old + prox_num_fixed) / (theta + rho_h)
        return HFinalResult(h=h_new, theta=theta.reshape(h_old.shape[:-2]),
                            iters=k)

    def accept_fails(theta):
        return bool(fails(theta))                         # the host sync

    # theta doubles exactly in f32, so the host keeps its own f32 copy and
    # the stop test needs no sync.
    theta_host = np.float32(theta0)
    theta = h_old.new_full((), float(theta_host))   # a fill, not a copy
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
