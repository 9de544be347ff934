"""Closed-form ADMM subproblem solvers (elementwise, no control flow).

Counterpart of `admm_lstm_tpu/solvers/closed_form.py`.  Each function is
the whole-slab version of one per-timestep update rule of the reference's
eager loop; the CUDA sweep kernel (csrc/gate_sweep.cu) fuses one timestep
of them.

Two of the reference's "iterative" updates are provably non-iterative and
are closed-form here, as in the JAX package (their backtracking loops can
never execute):

* ``wy`` (admm.py:246-280): the acceptance test compares
  ``original_func(beta)`` with ``estimated_func(beta, theta)``, which
  itself evaluates ``original_func(beta)`` (the estimate is taken at the
  candidate point, a reference quirk), so the loop never runs and theta
  is always 1/2 after the final halving.
* ``c`` (admm.py:405-436): the loop tests the candidate ``current_c``,
  initialized to ``c`` itself, so the first test is ``f(c) > f(c)``:
  never true.  Hence theta = 1/2 always.
"""

from __future__ import annotations

import torch


def gate_ifgo_update(lam, rho1, act, p1, p2, p3, var2, rho2, lam2):
    """Closed-form i/f/g/o update (admm.py:353-386).

    new_gate = -(lam - rho1*act + (rho2*(p2*p3 - var2) - lam2)*p1)
               / (rho1 + rho2*p1^2)
    """
    return -(lam - rho1 * act + (rho2 * (p2 * p3 - var2) - lam2) * p1) / (
        rho1 + rho2 * p1 * p1)


def c_update(c_old, o_new, h_old, lam_h, lam_c, rho_h, rho_c,
             f_new, c_prev, i_new, g_new):
    """Cell-state prox-linear update with the constant theta = 1/2
    (admm.py:388-436)."""
    tc = torch.tanh(c_old)
    z = h_old + lam_h / rho_h
    gradient = (tc * o_new - z) * o_new * (1.0 - tc * tc)
    a_term = lam_c / rho_c - f_new * c_prev - i_new * g_new
    theta = 0.5
    return (theta * c_old - gradient - rho_c * a_term) / (rho_c + theta)


def h_interior_update(o_new, tanh_c_new, lam_h, rho_h):
    """h update for t < T (admm.py:455-457): h = o*tanh(c) - lam_h/rho_h."""
    return (rho_h * o_new * tanh_c_new - lam_h) / rho_h


def a_update(train_y, hw, rho_y, lam_y, batch_size: int, with_dual_y: bool):
    """Output-auxiliary closed form (admm.py:489-502), with the reference's
    batch-size scaling of the data term."""
    num = 2.0 * train_y + batch_size * rho_y * hw
    if with_dual_y:
        num = num - batch_size * lam_y
    return num / (2.0 + batch_size * rho_y)


def dual_ifgo_update(lam, rho, gate_new, act):
    """lam += rho * (gate - act(x_t Wx + h_{t-1} Wh))  (admm.py:512-522)."""
    return lam + rho * (gate_new - act)


def dual_c_update(lam_c, rho_c, c_new, f_new, c_prev, i_new, g_new):
    """lam_c += rho_c * (c - (f*c_{t-1} + i*g))  (admm.py:524-530)."""
    return lam_c + rho_c * (c_new - (f_new * c_prev + i_new * g_new))


def dual_h_update(lam_h, rho_h, h_new, o_new, tanh_c_new):
    """lam_h += rho_h * (h - o*tanh(c)); applied at t = T only."""
    return lam_h + rho_h * (h_new - o_new * tanh_c_new)


def dual_y_update(lam_y, rho_y, a_new, hw):
    """lam_y += rho_y * (a - h_T @ wy)  (admm.py:541-546)."""
    return lam_y + rho_y * (a_new - hw)
