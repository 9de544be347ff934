"""ADMM-LSTM-S: the oldest (2022) formulation, with biases, a backward
timestep sweep with per-timestep weight updates, and dual ascent only on
the final-timestep residuals (reference: ADMMLSTMS/{main,common}.py).

Counterpart of `admm_lstm_tpu/variants/admm_s.py`, whose docstring
recovers the structure:
  * every epoch re-initializes all primal trajectories from a full forward
    pass with the current weights (main.py:236), so the persistent state
    is the 14 weight tensors and 11 duals;
  * the sweep runs t = T-1 .. 0 (main.py:251); the weights move a
    tau-damped step at every timestep (common.py:119-149), reading the
    mixed fresh (t' >= t) and stale (t' < t) slabs, so the sweep is a
    strictly ordered loop over t and is not vectorised over time;
  * most closed forms have an undualized branch for t < T-1 and a
    dualized one at t = T-1; update_h also distinguishes t = T-2
    (common.py:62-86);
  * the duals update once per epoch from the final-timestep residuals
    (main.py:279-289).

Here the forward is a Python loop that writes fresh slabs, which the
sweep then updates in place: the final and second-to-last timesteps
peeled, then the interior ones.  There is no line search, so an epoch
never waits for the host.  The Frobenius norms of the z updates are
majorization constants over the whole (B, H) slab and stay 0-d tensors on
the device.  Weight naming follows the reference: W* multiplies h, U*
multiplies x (the reverse of the core model's wx/wh).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

from admm_lstm_torch.utils.device import (as_tensor, matmul_precision,
                                          resolve_device)
from admm_lstm_torch.utils.logging import info
from admm_lstm_torch.utils.timer import Timer

# Group order of stacked weights and duals: f, i, o, c (c is the
# candidate-cell gate, tanh; the reference calls its variables zc / c_).
_IS_TANH_S = (False, False, False, True)


class ADMMSState(NamedTuple):
    w: torch.Tensor    # (4, H, H) hidden-side weights W_f, W_i, W_o, W_c
    u: torch.Tensor    # (4, I, H) input-side weights U_*
    b: torch.Tensor    # (4, H) biases b_*
    wy: torch.Tensor   # (H, O)
    by: torch.Tensor   # (O,)
    # Duals (final-timestep residuals only, (B, H) each):
    lam_z: torch.Tensor   # (4, B, H) on z = hW + xU + b (lambda 1,3,5,7)
    lam_g: torch.Tensor   # (4, B, H) on gate = act(z) (lambda 2,4,6,8)
    lam9: torch.Tensor    # (B, H) cell recursion
    lam10: torch.Tensor   # (B, H) h = o * tanh(c)
    lam11: torch.Tensor   # (B, O) output fit
    epoch: int


@dataclasses.dataclass(frozen=True)
class ADMMSRules:
    """Constants from ADMMLSTMS/main.py:183-218 and common.py."""

    rho_z: float = 1.0      # rho1,3,5,7
    rho_g: float = 1.0      # rho2,4,6,8
    rho9: float = 1.0
    rho10: float = 0.1
    rho11: float = 1e-5
    mu: float = 1e-8        # weight-update history damping (main.py:214)
    alpha: float = 1.0
    r_wy: float = 0.01      # update_w_yh step (common.py:40)
    r_h: float = 100.0      # update_h damping (common.py:63)
    tau: float = 2400.0     # update_w/u step damping (common.py:122)
    matmul_precision: str = 'highest'


def _dsig(x):
    s = torch.sigmoid(x)
    return s * (1.0 - s)


def _dtanh(x):
    return 1.0 - torch.tanh(x) ** 2


def _acts(z):
    """(4, ...) pre-activations in f, i, o, c order -> activations."""
    return torch.cat([torch.sigmoid(z[:3]), torch.tanh(z[3:])])


def init_weights_like_reference(seed: int, input_size: int, hidden_size: int,
                                output_size: int, device='cpu'):
    """The reference's `torch.randn` draws (ADMMLSTMS/main.py:82-96: Wf,
    Uf, bf, Wi, Ui, bi, Wo, Uo, bo, Wc, Uc, bc, Wy, by) from
    `torch.Generator('cpu').manual_seed(seed)`, the stream the reference's
    `torch.manual_seed(seed)` starts, drawn on the CPU and then moved to
    `device`.  Returns (w, u, b, wy, by) stacked in f, i, o, c order."""
    shapes = []
    for _ in range(4):
        shapes += [(hidden_size, hidden_size), (input_size, hidden_size),
                   (hidden_size,)]
    shapes += [(hidden_size, output_size), (output_size,)]
    gen = torch.Generator('cpu').manual_seed(seed)
    draws = [torch.randn(s, generator=gen).to(device) for s in shapes]
    w = torch.stack([draws[0], draws[3], draws[6], draws[9]])
    u = torch.stack([draws[1], draws[4], draws[7], draws[10]])
    b = torch.stack([draws[2], draws[5], draws[8], draws[11]])
    return w, u, b, draws[12], draws[13]


def init_admm_s_state(w, u, b, wy, by, batch: int) -> ADMMSState:
    """The weights with every dual at zero."""
    hidden, out = w.shape[1], wy.shape[1]
    zeros4 = w.new_zeros((4, batch, hidden))
    return ADMMSState(w=w, u=u, b=b, wy=wy, by=by, lam_z=zeros4,
                      lam_g=torch.zeros_like(zeros4),
                      lam9=w.new_zeros((batch, hidden)),
                      lam10=w.new_zeros((batch, hidden)),
                      lam11=w.new_zeros((batch, out)), epoch=0)


def admm_s_state_from_numpy(state, device='cpu') -> ADMMSState:
    """The port's ADMMSState from a JAX package's ADMMSState (or any object
    with its fields) whose leaves convert with np.asarray."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    return ADMMSState(**{f: t(getattr(state, f)) for f in ADMMSState._fields
                         if f != 'epoch'}, epoch=int(state.epoch))


def _forward(state: ADMMSState, x_tm: torch.Tensor, collect: bool = True):
    """Full unroll (main.py:159-180) on (T, B, I) inputs: the slabs z,
    gate (4, T, B, H) [f, i, o, c_], c, h (T+1, B, H) and y (B, O); with
    collect=False only y (the others are None)."""
    seq_len, batch = x_tm.shape[0], x_tm.shape[1]
    hidden = state.w.shape[1]
    xproj = (torch.matmul(x_tm.unsqueeze(0), state.u.unsqueeze(1))
             + state.b[:, None, None, :])                # (4, T, B, H)
    h_t = x_tm.new_zeros((batch, hidden))
    c_t = h_t
    z = gate = c = h = None
    if collect:
        z = x_tm.new_empty((4, seq_len, batch, hidden))
        gate = torch.empty_like(z)
        c = x_tm.new_zeros((seq_len + 1, batch, hidden))
        h = torch.zeros_like(c)
    for t in range(seq_len):
        z_t = xproj[:, t] + torch.matmul(h_t, state.w)
        act = _acts(z_t)
        f, i, o, c_ = act
        c_t = f * c_t + i * c_
        h_t = o * torch.tanh(c_t)
        if collect:
            z[:, t], gate[:, t], c[t + 1], h[t + 1] = z_t, act, c_t, h_t
    y = h_t @ state.wy + state.by
    return z, gate, c, h, y


def predict(state: ADMMSState, x) -> torch.Tensor:
    """(B, T, I) inputs -> (B, O) predictions."""
    x_tm = torch.as_tensor(x, dtype=torch.float32,
                           device=state.w.device).transpose(0, 1)
    return _forward(state, x_tm, collect=False)[-1]


def _update_weights_group(g: int, slabs, w, u, b, x_tm, lam_z_g,
                          rules: ADMMSRules, seq_len):
    """update_w / update_u / update_b for one gate group
    (common.py:119-161): the sum of the undualized residuals over
    t < T-1 (weighted mu) and the dualized final-timestep term (weighted
    rho); a tau-damped step for W and U, a closed form for b.  Reads the
    carried (mixed fresh/stale) slabs.  Returns the group's new (W, U, b).
    """
    z_slab, h_slab = slabs  # (T, B, H), (T+1, B, H)
    rho = rules.rho_z
    mu, tau, alpha = rules.mu, rules.tau, rules.alpha
    w_g, u_g, b_g = w[g], u[g], b[g]
    last = seq_len - 1

    def sum_outer(left, right):
        """sum over t < T-1 and b of left^T right: (T, B, D), (T, B, K)."""
        return left[:last].reshape(-1, left.shape[-1]).T \
            @ right[:last].reshape(-1, right.shape[-1])

    h_prev_all = h_slab[:-1]   # rows t-1 for t = 0 .. T-1
    x_u = x_tm @ u_g
    resid = z_slab - h_prev_all @ w_g - x_u
    resid_wb = resid - b_g     # with the bias: update_w's residual
    final = resid_wb[last] + lam_z_g / rho

    # W step (common.py:119-133): the interior sum contracts h^T, so does
    # the final term.
    final_w = h_slab[last].T @ final
    w_new = (w_g + (mu * sum_outer(h_prev_all, resid_wb) + rho * final_w)
             / tau) / alpha

    # U step (common.py:136-149) with the fresh W (the reference calls W
    # then U; update_u's residual uses the W passed in, the fresh one).
    h_w = h_prev_all @ w_new
    resid_u = z_slab - h_w - x_u - b_g
    final_u = resid_u[last] + lam_z_g / rho
    final_u_term = x_tm[last].T @ final_u
    u_new = (u_g + (mu * sum_outer(x_tm, resid_u) + rho * final_u_term)
             / tau) / alpha

    # b step (common.py:152-161): the interior terms without the bias
    # subtraction (a reference quirk), the final term with lam/rho and
    # also no bias.
    resid_b = z_slab - h_w - x_tm @ u_new
    interior_b = torch.sum(resid_b[:last], dim=0)    # (B, H)
    final_b = resid_b[last] + lam_z_g / rho
    res = (mu * interior_b + rho * final_b) / ((seq_len - 2) * mu + rho)
    b_new = torch.mean(res, dim=0) / alpha
    return w_new, u_new, b_new


def _sweep_iteration(carry: Dict[str, torch.Tensor], t: int, mode: str,
                     duals, x_tm, train_y, rules: ADMMSRules,
                     seq_len) -> None:
    """One backward-sweep iteration (main.py:251-277), in place on
    `carry`.

    mode: 'final' (t = T-1), 'second' (t = T-2) or 'interior'.
    carry: w, u, b, z, gate (4, T, B, H), c, h (T+1, B, H; row 0 = t=-1)
    are written in place; wy, by and y (B, O) are replaced.
    """
    w, u, b = carry['w'], carry['u'], carry['b']
    z, gate, c, h = carry['z'], carry['gate'], carry['c'], carry['h']
    wy, by, y = carry['wy'], carry['by'], carry['y']
    rz, rg = rules.rho_z, rules.rho_g
    r9, r10, r11 = rules.rho9, rules.rho10, rules.rho11
    alpha = rules.alpha
    batch = x_tm.shape[1]
    lam_z, lam_g, lam9, lam10, lam11 = duals

    x_t = x_tm[t]
    h_t = h[t + 1]
    c_t = c[t + 1]
    c_prev = c[t]
    h_prev = h[t]

    if mode == 'final':
        # y / Wy / by (common.py:31-53) with the stale forward h[T-1].
        hw = h_t @ wy
        y = ((2.0 * train_y / batch + r11 * hw + r11 * by - lam11)
             / (2.0 / batch + r11))
        temp1 = y - hw - by + lam11 / r11
        wy = wy + r11 * (h_t.T @ temp1) / rules.r_wy
        temp1b = y - h_t @ wy + lam11 / r11
        by = torch.mean(temp1b, dim=0) / alpha
        carry.update(wy=wy, by=by, y=y)

    # --- h update (common.py:62-86) ---
    o_t = gate[2, t]
    if mode == 'final':
        temp1 = o_t * torch.tanh(c_t) - lam10 / r10
        temp2 = y - h_t @ wy - by + lam11 / r11
        h_new = ((rules.r_h - r10) * h_t + r10 * temp1
                 + r11 * (temp2 @ wy.T)) / rules.r_h / alpha
    else:
        def fun(gi, lam0, rho0):
            # Fun(z, h, W, x, U, b, lam0, rho0, t) (common.py:56-59).
            temp1 = (z[gi, t + 1] - h_t @ w[gi] - x_tm[t + 1] @ u[gi]
                     - b[gi] + lam0 / rho0)
            return temp1 @ w[gi].T

        if mode == 'second':
            temps = sum(rules.rho_z * fun(gi, lam_z[gi], rules.rho_z)
                        for gi in range(4))
            temp5 = rules.mu * (h_t - o_t * torch.tanh(c_t))
        else:
            temps = sum(fun(gi, 0.0, 1.0) for gi in range(4))
            temp5 = h_t - o_t * torch.tanh(c_t)
        h_new = (h_t + (temps - temp5) / rules.r_h) / alpha
    h[t + 1] = h_new

    def group_block(gi, g_new):
        """The z, W, U, b updates every group shares, after its gate."""
        gate[gi, t] = g_new
        # z update (common.py:102-116 sigmoid / 222-235 tanh).
        is_tanh = _IS_TANH_S[gi]
        act = torch.tanh if is_tanh else torch.sigmoid
        dact = _dtanh if is_tanh else _dsig
        z_old = z[gi, t]
        lin = h_prev @ w[gi] + x_t @ u[gi] + b[gi]
        if mode == 'final':
            out_l = g_new + lam_g[gi] / rg
            norm = torch.linalg.vector_norm(out_l)
            temp_h = ((4.0 + 2.0 * norm) if is_tanh
                      else (0.5 * (1.0 + norm) + 0.125))
            temp1 = lin - lam_z[gi] / rz
            temp2 = (act(z_old) - out_l) * dact(z_old)
            temp3 = rz * temp1 + 0.5 * temp_h * z_old - rg * temp2
            z_new = 2.0 * temp3 / (2.0 * rz + rg * temp_h) / alpha
        else:
            norm = torch.linalg.vector_norm(g_new)
            temp2 = (act(z_old) - g_new) * dact(z_old)
            if is_tanh:
                temp_h = 4.0 + 2.0 * norm
                z_new = ((2.0 * lin + temp_h * z_old - 2.0 * temp2)
                         / (2.0 + temp_h))
            else:
                temp_h = 0.5 * (1.0 + norm) + 0.125
                temp3 = lin + 0.5 * temp_h * z_old - temp2
                z_new = 2.0 * temp3 / (2.0 + temp_h) / alpha
        z[gi, t] = z_new
        w[gi], u[gi], b[gi] = _update_weights_group(
            gi, (z[gi], h), w, u, b, x_tm, lam_z[gi], rules, seq_len)

    # --- o group (common.py:89-99) ---
    tc = torch.tanh(c_t)
    if mode == 'final':
        o_new = ((rg * torch.sigmoid(z[2, t]) - lam_g[2]
                  + r10 * (h[t + 1] + lam10 / r10) * tc)
                 / (rg + r10 * tc * tc) / alpha)
    else:
        o_new = ((torch.sigmoid(z[2, t]) + h[t + 1] * tc)
                 / (1.0 + tc * tc) / alpha)
    group_block(2, o_new)

    # --- c update (common.py:164-178) ---
    o_new = gate[2, t]
    if mode == 'final':
        temp_h = 4.0 + 2.0 * torch.linalg.vector_norm(
            (h[t + 1] + lam10 / r10) / o_new)
        temp1 = gate[0, t] * c_prev + gate[1, t] * gate[3, t] - lam9 / r9
        temp2 = o_new * o_new * temp_h
        temp3 = (o_new * torch.tanh(c_t) - (h[t + 1] + lam10 / r10)) \
            * o_new * _dtanh(c_t)
        c_new = (2.0 * r9 * temp1 + r10 * temp2 * c_t - 2.0 * r10 * temp3) \
            / (2.0 * r9 + r10 * temp2)
    else:
        temp_h = 4.0 + 2.0 * torch.linalg.vector_norm(h[t + 1] / o_new)
        temp1 = gate[0, t] * c_prev + gate[1, t] * gate[3, t]
        temp2 = o_new * o_new * temp_h
        temp3 = (o_new * torch.tanh(c_t) - h[t + 1]) * o_new * _dtanh(c_t)
        c_new = (2.0 * temp1 + temp2 * c_t - 2.0 * temp3) / (2.0 + temp2)
    c[t + 1] = c_new

    # --- f group (common.py:181-193) ---
    if mode == 'final':
        f_new = ((rg * torch.sigmoid(z[0, t]) - lam_g[0]
                  + r9 * c_prev * (c[t + 1] - gate[1, t] * gate[3, t]
                                   + lam9 / r9))
                 / (rg + r9 * c_prev * c_prev) / alpha)
    else:
        f_new = ((torch.sigmoid(z[0, t])
                  + (c[t + 1] - gate[1, t] * gate[3, t]) * c_prev)
                 / (1.0 + c_prev * c_prev) / alpha)
    group_block(0, f_new)

    # --- i group (common.py:196-206) ---
    cc = gate[3, t]
    if mode == 'final':
        i_new = ((rg * torch.sigmoid(z[1, t]) - lam_g[1]
                  + (r9 * c[t + 1] - r9 * gate[0, t] * c_prev + lam9) * cc)
                 / (rg + r9 * cc * cc) / alpha)
    else:
        i_new = ((torch.sigmoid(z[1, t]) + (c[t + 1] - gate[0, t] * c_prev)
                  * cc) / (1.0 + cc * cc) / alpha)
    group_block(1, i_new)

    # --- c_ (candidate cell) group (common.py:209-219) ---
    if mode == 'final':
        cc_new = ((rg * torch.tanh(z[3, t]) - lam_g[3]
                   + gate[1, t] * (r9 * c[t + 1] - r9 * gate[0, t] * c_prev
                                   + lam9))
                  / (rg + r9 * gate[1, t] * gate[1, t]) / alpha)
    else:
        cc_new = ((torch.tanh(z[3, t]) + gate[1, t]
                   * (c[t + 1] - gate[0, t] * c_prev))
                  / (1.0 + gate[1, t] * gate[1, t]) / alpha)
    group_block(3, cc_new)


def admm_s_step(state: ADMMSState, x_tm: torch.Tensor, train_y: torch.Tensor,
                rules: ADMMSRules) -> ADMMSState:
    """One full ADMM-LSTM-S epoch (main.py:224-289) on time-major inputs
    x_tm (T, B, I)."""
    seq_len = x_tm.shape[0]

    # 1. Re-seed the primal trajectories from a forward pass (main.py:236).
    z, gate, c, h, y = _forward(state, x_tm)
    carry = dict(w=state.w.clone(), u=state.u.clone(), b=state.b.clone(),
                 wy=state.wy, by=state.by, z=z, gate=gate, c=c, h=h, y=y)
    duals = (state.lam_z, state.lam_g, state.lam9, state.lam10, state.lam11)

    # 2. The backward sweep, the two special timesteps peeled, in order.
    for t in range(seq_len - 1, -1, -1):
        mode = ('final' if t == seq_len - 1 else
                'second' if t == seq_len - 2 else 'interior')
        _sweep_iteration(carry, t, mode, duals, x_tm, train_y, rules,
                         seq_len)

    w, u, b, wy, by, y = (carry[k] for k in ('w', 'u', 'b', 'wy', 'by', 'y'))

    # 3. Dual ascent on the final-timestep residuals (main.py:279-289).
    t_last = seq_len - 1
    lin_T = (torch.matmul(h[t_last], w) + torch.matmul(x_tm[t_last], u)
             + b[:, None, :])
    z_T, gate_T = z[:, t_last], gate[:, t_last]
    acts_T = _acts(z_T)
    lam_z_new = state.lam_z + rules.rho_z * (z_T - lin_T)
    lam_g_new = state.lam_g + rules.rho_g * (gate_T - acts_T)
    lam9_new = state.lam9 + rules.rho9 * (
        c[t_last + 1] - gate_T[0] * c[t_last] - gate_T[1] * gate_T[3])
    lam10_new = state.lam10 + rules.rho10 * (
        h[t_last + 1] - gate_T[2] * torch.tanh(c[t_last + 1]))
    lam11_new = state.lam11 + rules.rho11 * (y - h[t_last + 1] @ wy - by)

    return ADMMSState(w=w, u=u, b=b, wy=wy, by=by, lam_z=lam_z_new,
                      lam_g=lam_g_new, lam9=lam9_new, lam10=lam10_new,
                      lam11=lam11_new, epoch=state.epoch + 1)


def losses(state: ADMMSState, x_tm, train_y, test_x_tm, test_y):
    """The train and validation MSE of the state's predictions (0-d
    tensors on the device)."""
    return tuple(torch.mean((_forward(state, x, collect=False)[-1] - y) ** 2)
                 for x, y in ((x_tm, train_y), (test_x_tm, test_y)))


def epoch(state: ADMMSState, x_tm, train_y, test_x_tm, test_y,
          rules: ADMMSRules):
    """One epoch and its two losses, as the JAX package's
    `_jitted_epoch` runs them."""
    state = admm_s_step(state, x_tm, train_y, rules)
    return state, losses(state, x_tm, train_y, test_x_tm, test_y)


def admm_s_demo(num_epochs: int, n_hiddens: int, train_x, train_y,
                test_x, test_y, seed: int = 0,
                rules: ADMMSRules = ADMMSRules(),
                log_every: int = 1, results_path: str | None = None,
                device='cuda') -> Dict[str, object]:
    """Full ADMM-LSTM-S run mirroring ADMMLSTMS/main.py, on `device`
    ('cuda' by default; the CPU only when asked), from
    `init_weights_like_reference(seed)`, including the comparison-cache
    export (main.py:344-359) when `results_path` is set.  The per-epoch
    losses stay on the device until a log line or the end.

    Returns {'name', 'train_loss', 'val_loss', 'state', 'seconds'}."""
    device = resolve_device(device)
    with matmul_precision(rules.matmul_precision):
        return _admm_s_demo(num_epochs, n_hiddens, train_x, train_y, test_x,
                            test_y, seed, rules, log_every, results_path,
                            device)


def _admm_s_demo(num_epochs, n_hiddens, train_x, train_y, test_x, test_y,
                 seed, rules, log_every, results_path, device):
    train_x, train_y = as_tensor(train_x, device), as_tensor(train_y, device)
    test_x, test_y = as_tensor(test_x, device), as_tensor(test_y, device)
    x_tm = train_x.transpose(0, 1).contiguous()
    test_x_tm = test_x.transpose(0, 1).contiguous()
    state = init_admm_s_state(*init_weights_like_reference(
        seed, train_x.shape[2], n_hiddens, train_y.shape[1], device=device),
        batch=train_x.shape[0])

    tl, vl = map(float, losses(state, x_tm, train_y, test_x_tm, test_y))
    loss_train, loss_test = [tl], [vl]
    info(f'ADMM-LSTM-S: iter 0, loss_train: {tl:.6f}, loss_test: {vl:.6f}')

    timer = Timer()
    timer.start()
    tls, vls = [], []
    for n in range(1, num_epochs + 1):
        state, (tl, vl) = epoch(state, x_tm, train_y, test_x_tm, test_y,
                                rules)
        tls.append(tl)
        vls.append(vl)
        if log_every and n % log_every == 0:
            info(f'ADMM-LSTM-S: iter {n}, loss_train: {float(tl):.6f}, '
                 f'loss_test: {float(vl):.6f}')
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    timer.pause()
    if tls:
        loss_train += torch.stack(tls).cpu().tolist()
        loss_test += torch.stack(vls).cpu().tolist()

    if results_path:
        with open(results_path, 'w') as f:
            f.write('admm_s_loss = { \n    "name": "ADMM-LSTM-S", \n'
                    '    "train_loss": [')
            f.write(', '.join(str(v) for v in loss_train) + ', ],\n')
            f.write('    "val_loss": [')
            f.write(', '.join(str(v) for v in loss_test) + ', ]\n}')

    return {'name': 'ADMM-LSTM-S', 'train_loss': loss_train,
            'val_loss': loss_test, 'state': state,
            'seconds': timer.get_elapsed_time()}
