"""ADMM-LSTM-L: the Liu-et-al. formulation with explicit pre-activation
variables (reference: comparison_experiment/admm_l/{main,admm_lstm}.py).

Counterpart of `admm_lstm_tpu/variants/admm_l.py`, whose docstring
derives the formulation: per-gate pre-activation auxiliaries
z_f, z_i, z_o, z_g with their own duals, a cell-recursion dual (lambda9),
an h = o * tanh(c) dual (lambda10) at every t and an output dual
(lambda11); the weights move by descent-probe line searches, and several
updates use global reductions (max |.| and the sum of o^2 over the whole
(B, H) slab) as majorization constants, which stay 0-d tensors on the
device.

Slabs keep the JAX layout, time-major and batch-major: z, gate and their
duals (4, T, B, H) in the gate order f, i, o, g; c and h (T+1, B, H) with
a zero row 0; lambda9/lambda10 (T, B, H); a and lambda11 (B, O).  The JAX
package runs the T-1 interior steps as a `lax.scan` and peels the final
one; here they are a Python loop that writes preallocated slabs.  Its
three `lax.while_loop` line searches (the Wy ascent probe, the four gates'
lockstep W/U searches, the final-h search) are blocked doubling searches
(solvers/prox_linear.doubling_search): one host sync per block of
BLOCK_K doublings, the same theta as the sequential loop, cap included.

Reference quirks kept:
  * update_a divides the data term by a hard-coded 4224
    (admm_lstm.py:263); `a_batch_scale=None` uses the true batch size,
    4224 reproduces the reference on GoogleStock;
  * update_Wy takes a ridge argument it never uses and does not halve
    theta after the search (admm_lstm.py:97-106).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from admm_lstm_torch.models.lstm import LSTMParams, mse_loss
from admm_lstm_torch.solvers.prox_linear import doubling_search
from admm_lstm_torch.utils.device import (as_tensor, matmul_precision,
                                          resolve_device)
from admm_lstm_torch.utils.logging import info
from admm_lstm_torch.utils.timer import Timer

class ADMMLState(NamedTuple):
    wx: torch.Tensor      # (4, I, H) input-side weights W_f, W_i, W_o, W_g
    wh: torch.Tensor      # (4, H, H) hidden-side weights U_*
    wy: torch.Tensor      # (H, O)
    z: torch.Tensor       # (4, T, B, H) pre-activations z_f, z_i, z_o, z_g
    gate: torch.Tensor    # (4, T, B, H) activations f, i, o, g
    c: torch.Tensor       # (T+1, B, H), row 0 = t=-1 zeros
    h: torch.Tensor       # (T+1, B, H)
    a: torch.Tensor       # (B, O)
    lam_z: torch.Tensor   # (4, T, B, H) duals on z = xW + hU (lambda 1,3,5,7)
    lam_g: torch.Tensor   # (4, T, B, H) duals on gate = act(z) (2,4,6,8)
    lam9: torch.Tensor    # (T, B, H) cell recursion
    lam10: torch.Tensor   # (T, B, H) h = o * tanh(c)
    lam11: torch.Tensor   # (B, O)
    epoch: int


@dataclasses.dataclass(frozen=True)
class ADMMLRules:
    """Static constants (reference admm_l/main.py:112-130)."""

    ridge_w: float = 1e-6        # lambda00
    ridge_u: float = 1e-6        # lambda02
    rho_singular: float = 1.0    # z = xW + hU penalties (lambda 1,3,5,7)
    rho_plural: float = 1.0      # gate = act(z) penalties (lambda 2,4,6,8)
    rho9: float = 1.0
    rho10: float = 1.0
    rho11: float = 1e-4
    wy_theta0: float = 0.01
    max_backtrack: int = 60
    a_batch_scale: Optional[int] = None   # None => true batch size; 4224 = quirk
    matmul_precision: str = 'highest'


def _dsig(x):
    s = torch.sigmoid(x)
    return s * (1.0 - s)


def _dtanh(x):
    return 1.0 - torch.tanh(x) ** 2


def _acts(z):
    """(4, ...) pre-activations in this module's gate order f, i, o, g
    (the reference's update order, admm_l/main.py:141-164) ->
    activations; only z_g takes tanh."""
    return torch.cat([torch.sigmoid(z[:3]), torch.tanh(z[3:])])


def init_weights_like_reference(seed: int, input_size: int, hidden_size: int,
                                output_size: int, scale: float = 0.1,
                                device='cpu'):
    """The reference admm_l_demo's `torch.randn(...) * 0.1` draws
    (main.py:75-83: Wf, Uf, Wi, Ui, Wo, Uo, Wg, Ug, Wy) from
    `torch.Generator('cpu').manual_seed(seed)`, the stream the reference's
    `torch.manual_seed(seed)` starts, drawn on the CPU and then moved to
    `device`.  Returns (wx, wh, wy) stacked in f, i, o, g order."""
    gen = torch.Generator('cpu').manual_seed(seed)
    shapes = [(input_size, hidden_size), (hidden_size, hidden_size)] * 4 + [
        (hidden_size, output_size)]
    draws = [torch.randn(s, generator=gen) * scale for s in shapes]
    wf, uf, wi, ui, wo, uo, wg, ug, wy = (d.to(device) for d in draws)
    return (torch.stack([wf, wi, wo, wg]), torch.stack([uf, ui, uo, ug]), wy)


def _to_core_params(wx, wh, wy) -> LSTMParams:
    """Map the f, i, o, g stacking to the core model's i, f, g, o order
    for inference (stacked views: indexing with a list would copy the
    index to the card and wait for the stream)."""
    perm = lambda w: torch.stack((w[1], w[0], w[3], w[2]))
    return LSTMParams(wx=perm(wx), wh=perm(wh), wy=wy)


def _project(m, w):
    """(T, B, D) inputs times (4, D, H) weights -> (4, T, B, H)."""
    return torch.matmul(m.unsqueeze(0), w.unsqueeze(1))


def _forward_histories(wx, wh, wy, x_tm):
    """Full unroll returning the z and gate histories (main.py:85-104):
    z, gate (4, T, B, H), c, h (T+1, B, H), a (B, O)."""
    seq_len, batch = x_tm.shape[0], x_tm.shape[1]
    hidden = wh.shape[1]
    xproj = _project(x_tm, wx)                       # (4, T, B, H)
    z = x_tm.new_empty((4, seq_len, batch, hidden))
    gate = torch.empty_like(z)
    c = x_tm.new_zeros((seq_len + 1, batch, hidden))
    h = torch.zeros_like(c)
    h_t, c_t = h[0], c[0]
    for t in range(seq_len):
        z_t = xproj[:, t] + torch.matmul(h_t, wh)
        act = _acts(z_t)
        f, i, o, g = act
        c_t = f * c_t + i * g
        h_t = o * torch.tanh(c_t)
        z[:, t], gate[:, t], c[t + 1], h[t + 1] = z_t, act, c_t, h_t
    return z, gate, c, h, h_t @ wy


def init_admm_l_state(wx, wh, wy, x_tm) -> ADMMLState:
    z, gate, c, h, a = _forward_histories(wx, wh, wy, x_tm)
    seq_len, batch = x_tm.shape[0], x_tm.shape[1]
    hidden = wh.shape[1]
    zs = x_tm.new_zeros((4, seq_len, batch, hidden))
    return ADMMLState(
        wx=wx, wh=wh, wy=wy, z=z, gate=gate, c=c, h=h, a=a,
        lam_z=zs, lam_g=torch.zeros_like(zs),
        lam9=x_tm.new_zeros((seq_len, batch, hidden)),
        lam10=x_tm.new_zeros((seq_len, batch, hidden)),
        lam11=torch.zeros_like(a), epoch=0)


def admm_l_state_from_numpy(state, device='cpu') -> ADMMLState:
    """The port's ADMMLState from a JAX package's ADMMLState (or any object
    with its fields) whose leaves convert with np.asarray."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    return ADMMLState(**{f: t(getattr(state, f)) for f in ADMMLState._fields
                         if f != 'epoch'}, epoch=int(state.epoch))


def _update_wy(state: ADMMLState, rules: ADMMLRules):
    """admm_lstm.py:80-106: the ascent-probe search; the new Wy is the
    probe point.  Returns (wy, theta)."""
    rho11 = rules.rho11
    h_last = state.h[-1]
    resid = state.a - h_last @ state.wy + state.lam11 / rho11
    grad = rho11 * (h_last.T @ resid)
    f_at_w = 0.5 * rho11 * torch.sum(resid * resid)

    # h_last @ probe(theta) assembled from two fixed products (linearity).
    hgrad = h_last @ grad
    hw0 = h_last @ state.wy

    def fails(theta):                       # theta: (K,)
        th = theta[:, None, None]
        r = state.a - (hw0 + hgrad / th) + state.lam11 / rho11
        obj = 0.5 * rho11 * torch.sum(r * r, dim=(1, 2))
        diff = grad / th
        # P subtracts the inner product (admm_lstm.py:92-95).
        est = (f_at_w - torch.sum(grad * diff, dim=(1, 2))
               + 0.5 * theta * torch.sum(diff * diff, dim=(1, 2)))
        return obj > est

    theta, _ = doubling_search(fails, state.wy.new_full((), rules.wy_theta0),
                            rules.max_backtrack)
    return state.wy + grad / theta, theta   # no halving, no ridge (quirk)


def _weight_stage(m_inputs, fixed_proj, weights, z_slab, lam_slab,
                  ridge, rules: ADMMLRules, grad_side_inputs):
    """update_W / update_U (admm_lstm.py:109-163), all 4 gates in lockstep.

    obj(W)  = 0.5 * rho * sum_t || -z_t + proj_t(W) + fixed_t - lam_t/rho ||^2
    grad    = rho * sum_t M_t^T resid_t
    descent probe W1 = W - grad/theta; accept when
      obj(W1) <= obj(W) + <grad, W1-W> + theta/2 |W1-W|^2
    final   W = (theta*W - grad) / (ridge + theta)

    Returns (weights, theta (4,))."""
    rho = rules.rho_singular
    d_in = grad_side_inputs.shape[-1]
    resid = -z_slab + _project(m_inputs, weights) + fixed_proj - lam_slab / rho
    grad = rho * torch.matmul(grad_side_inputs.reshape(-1, d_in).T,
                              resid.flatten(1, 2))
    obj_w = 0.5 * rho * torch.sum(resid * resid, dim=(1, 2, 3))
    # The projection is linear: resid(W - grad/theta) = resid -
    # grad_proj/theta, so the search is matmul-free.
    grad_proj = _project(m_inputs, grad)

    def fails(theta):                       # theta: (K, 4)
        r1 = resid - grad_proj / theta[:, :, None, None, None]
        obj1 = 0.5 * rho * torch.sum(r1 * r1, dim=(2, 3, 4))
        diff = -grad / theta[:, :, None, None]
        est = (obj_w + torch.sum(grad * diff, dim=(2, 3))
               + 0.5 * theta * torch.sum(diff * diff, dim=(2, 3)))
        return obj1 > est

    theta, _ = doubling_search(fails, weights.new_ones((4,)),
                            rules.max_backtrack)
    new = (theta[:, None, None] * weights - grad) / (ridge + theta)[:, None,
                                                                     None]
    return new, theta


def _sweep_step_core(x_t, z_o, gate_o, c_o, h_o, duals_t, h_prev, c_prev,
                     wx, wh, rules: ADMMLRules):
    """Interior-timestep primal updates in the reference order
    (main.py:150-167): zf, f, zi, i, zo, o, zg, g, c.  Returns the fresh
    z, gate (4, B, H) and c, and the per-t duals lambda_z, lambda_g and
    lambda9; h and lambda10 are the caller's.  duals_t = (lam_z (4, B, H),
    lam_g (4, B, H), lam9, lam10)."""
    rs, rp, r9, r10 = (rules.rho_singular, rules.rho_plural, rules.rho9,
                       rules.rho10)
    lam_z, lam_g, lam9, lam10 = duals_t
    zf_o, zi_o, zo_o, zg_o = z_o
    f_o, i_o, o_o, g_o = gate_o

    lin = torch.matmul(x_t, wx) + torch.matmul(h_prev, wh)   # (4, B, H)

    def update_z_sig(z_old, out, lin_g, l1, l2):
        # admm_lstm.py:166-174; note the global max majorization constant.
        temp = torch.max(torch.abs(out - l2 / rp))
        appro = 0.5 * (1.0 + temp) + 0.125
        form1 = lin_g - l1 / rs
        form2 = rp * (torch.sigmoid(z_old) - out + l2 / rp) * _dsig(z_old)
        form3 = rs * form1 + 0.5 * rp * appro * z_old - form2
        return 2.0 * form3 / (2.0 * rs + rp * appro)

    def update_z_tanh(z_old, out, lin_g, l1, l2):
        # admm_lstm.py:177-185.
        temp = torch.max(torch.abs(out - l2 / rp))
        appro = 2.0 * (1.0 + temp) + 2.0
        form1 = lin_g - l1 / rs
        form2 = rp * (torch.tanh(z_old) - out + l2 / rp) * _dtanh(z_old)
        form3 = rs * form1 + 0.5 * rp * appro * z_old - form2
        return 2.0 * form3 / (2.0 * rs + rp * appro)

    zf_n = update_z_sig(zf_o, f_o, lin[0], lam_z[0], lam_g[0])
    # update_f (admm_lstm.py:188-193)
    f_n = (rp * (torch.sigmoid(zf_n) + lam_g[0] / rp)
           + r9 * c_prev * (c_o - g_o * i_o + lam9 / r9)) / (
        rp + r9 * c_prev * c_prev)
    zi_n = update_z_sig(zi_o, i_o, lin[1], lam_z[1], lam_g[1])
    # update_i (admm_lstm.py:196-201)
    i_n = (rp * (torch.sigmoid(zi_n) + lam_g[1] / rp)
           + r9 * g_o * (c_o - c_prev * f_n + lam9 / r9)) / (
        rp + r9 * g_o * g_o)
    zo_n = update_z_sig(zo_o, o_o, lin[2], lam_z[2], lam_g[2])
    # update_o (admm_lstm.py:204-209)
    tc_o = torch.tanh(c_o)
    o_n = (rp * (torch.sigmoid(zo_n) + lam_g[2] / rp)
           + r10 * tc_o * (h_o - lam10 / r10)) / (rp + r10 * tc_o * tc_o)
    zg_n = update_z_tanh(zg_o, g_o, lin[3], lam_z[3], lam_g[3])
    # update_g (admm_lstm.py:212-217)
    g_n = (rp * (torch.tanh(zg_n) + lam_g[3] / rp)
           + r9 * i_n * (c_o - c_prev * f_n + lam9 / r9)) / (
        rp + r9 * i_n * i_n)
    # update_c (admm_lstm.py:220-235): a global max and the global sum of
    # o^2.
    temp = torch.max(torch.abs((h_o - lam10 / r10) / o_n))
    appro_h = 2.0 * (1.0 + temp) + 2.0
    form1 = r9 * (g_n * i_n + c_prev * f_n - lam9 / r9)
    form2 = r10 * (torch.tanh(c_o) * o_n - h_o + lam10 / r10) \
        * _dtanh(c_o) * o_n
    qua_o = torch.sum(o_n * o_n)
    form3 = 0.5 * r10 * qua_o * c_o * appro_h
    form4 = r9 + 0.5 * r10 * qua_o * appro_h
    c_n = (form1 - form2 + form3) / form4

    z_n = torch.stack([zf_n, zi_n, zo_n, zg_n])
    gate_n = torch.stack([f_n, i_n, o_n, g_n])

    # Dual ascent (main.py:175-191) with the fresh primal values; the
    # h-dependent duals (lambda10, and lambda9's use of it) are the
    # caller's.
    lam_g_n = lam_g + rp * (_acts(z_n) - gate_n)
    lam_z_n = lam_z + rs * (z_n - lin)
    lam9_n = lam9 + r9 * (c_n - g_n * i_n - c_prev * f_n)

    return z_n, gate_n, c_n, lam_z_n, lam_g_n, lam9_n


def _h_final_search(h_old_T, c_T, o_T, lam10_T, state: ADMMLState, wy_new,
                    rules: ADMMLRules):
    """update_h at t = T-1 (admm_lstm.py:238-258): the descent-probe
    search from theta = 1.  Returns (h_T, theta)."""
    r10, r11 = rules.rho10, rules.rho11
    form1 = r10 * (torch.tanh(c_T) * o_T + lam10_T / r10)
    hw_T = h_old_T @ wy_new
    form10 = -state.a + hw_T - state.lam11 / r11
    form11 = form10 @ wy_new.T
    # h1(theta) @ Wy assembled from fixed products (linearity).
    form11_wy = form11 @ wy_new
    f10_quad = 0.5 * r11 * torch.sum(form10 * form10)

    def fails(theta):                       # theta: (K,)
        th = theta[:, None, None]
        d = -r11 * form11 / th
        func1 = (f10_quad + r11 * torch.sum(form11 * d, dim=(1, 2))
                 + 0.5 * theta * torch.sum(d * d, dim=(1, 2)))
        form20 = state.a - (hw_T - r11 * form11_wy / th) \
            + state.lam11 / r11
        return 0.5 * r11 * torch.sum(form20 * form20, dim=(1, 2)) > func1

    theta, _ = doubling_search(fails, h_old_T.new_ones(()),
                            rules.max_backtrack)
    return (form1 - r11 * form11 + theta * h_old_T) / (r10 + theta), theta


def admm_l_step(state: ADMMLState, x_tm: torch.Tensor, train_y: torch.Tensor,
                rules: ADMMLRules) -> ADMMLState:
    """One full ADMM-LSTM-L epoch (main.py:139-191) on time-major inputs
    x_tm (T, B, I)."""
    seq_len, batch = x_tm.shape[0], x_tm.shape[1]
    r10, r11 = rules.rho10, rules.rho11

    # 1. Wy, then (W, U) per gate: the reference's order Wg, Ug, Wo, Uo,
    # Wi, Ui, Wf, Uf is independent across gates, so the four run in
    # lockstep (the W stage with the old U, then the U stage with the
    # fresh W, keeping the in-pair order).
    wy_new, _ = _update_wy(state, rules)
    h_hist = state.h[:-1]
    ridge_w = state.wx.new_full((4,), rules.ridge_w)
    ridge_u = state.wx.new_full((4,), rules.ridge_u)
    fixed_u = _project(h_hist, state.wh)
    wx_new, _ = _weight_stage(x_tm, fixed_u, state.wx, state.z, state.lam_z,
                              ridge_w, rules, grad_side_inputs=x_tm)
    fixed_w = _project(x_tm, wx_new)
    # update_U's gradient contracts against h (admm_lstm.py:147), its own
    # design side.
    wh_new, _ = _weight_stage(h_hist, fixed_w, state.wh, state.z,
                              state.lam_z, ridge_u, rules,
                              grad_side_inputs=h_hist)

    # 2. The sweep t = 0 .. T-2 into preallocated slabs, the final step
    # peeled.
    z_new, gate_new = torch.empty_like(state.z), torch.empty_like(state.gate)
    c_new, h_new = torch.zeros_like(state.c), torch.zeros_like(state.h)
    lam_z_new = torch.empty_like(state.lam_z)
    lam_g_new = torch.empty_like(state.lam_g)
    lam9_new = torch.empty_like(state.lam9)
    lam10_new = torch.empty_like(state.lam10)

    def step_t(t, h_prev, c_prev):
        out = _sweep_step_core(
            x_tm[t], state.z[:, t], state.gate[:, t], state.c[t + 1],
            state.h[t + 1], (state.lam_z[:, t], state.lam_g[:, t],
                             state.lam9[t], state.lam10[t]),
            h_prev, c_prev, wx_new, wh_new, rules)
        (z_new[:, t], gate_new[:, t], c_new[t + 1], lam_z_new[:, t],
         lam_g_new[:, t], lam9_new[t]) = out
        return out[1][2], out[2]                       # o, c

    h_prev, c_prev = state.h[0], state.c[0]
    for t in range(seq_len - 1):
        o_n, c_n = step_t(t, h_prev, c_prev)
        # update_h interior: h = tanh(c) * o + lam10/rho10
        # (admm_lstm.py:241-245).
        tco = torch.tanh(c_n) * o_n
        h_n = (r10 * (tco + state.lam10[t] / r10)) / r10
        lam10_new[t] = state.lam10[t] + r10 * (tco - h_n)
        h_new[t + 1] = h_n
        h_prev, c_prev = h_n, c_n

    # The final timestep t = T-1.
    t_last = seq_len - 1
    o_T, c_T = step_t(t_last, h_prev, c_prev)
    h_T, _ = _h_final_search(state.h[t_last + 1], c_T, o_T,
                             state.lam10[t_last], state, wy_new, rules)
    h_new[t_last + 1] = h_T

    # update_a and lambda11 at t = T-1 (admm_lstm.py:261-273).
    nb = rules.a_batch_scale or batch
    hw = h_T @ wy_new
    a_new = (2.0 * train_y / nb + r11 * hw - state.lam11) / (2.0 / nb + r11)
    lam11_new = state.lam11 + r11 * (a_new - hw)
    lam10_new[t_last] = state.lam10[t_last] + r10 * (torch.tanh(c_T) * o_T
                                                     - h_T)

    return ADMMLState(
        wx=wx_new, wh=wh_new, wy=wy_new, z=z_new, gate=gate_new, c=c_new,
        h=h_new, a=a_new, lam_z=lam_z_new, lam_g=lam_g_new, lam9=lam9_new,
        lam10=lam10_new, lam11=lam11_new, epoch=state.epoch + 1)


def epoch(state: ADMMLState, x_tm, train_x, train_y, test_x, test_y,
          rules: ADMMLRules):
    """One epoch and its train and validation losses (0-d tensors on the
    device), as the JAX package's `_jitted_epoch` runs them."""
    state = admm_l_step(state, x_tm, train_y, rules)
    params = _to_core_params(state.wx, state.wh, state.wy)
    return state, (mse_loss(params, train_x, train_y),
                   mse_loss(params, test_x, test_y))


def admm_l_demo(num_epochs: int, n_hiddens: int, train_x, train_y,
                test_x, test_y, seed: int = 0, save: bool = False,
                rules: ADMMLRules = ADMMLRules(), log_every: int = 1,
                device='cuda') -> Dict[str, object]:
    """Full ADMM-LSTM-L run mirroring admm_l_demo (main.py:71-208), on
    `device` ('cuda' by default; the CPU only when asked), from
    `init_weights_like_reference(seed)`.  The per-epoch losses stay on the
    device until a log line or the end.  save=True writes the model with
    ckpt.save_model('ADMM-LSTM-L').

    Returns {'name', 'train_loss', 'val_loss', 'params' (core i, f, g, o
    order), 'state', 'seconds'}."""
    device = resolve_device(device)
    with matmul_precision(rules.matmul_precision):
        return _admm_l_demo(num_epochs, n_hiddens, train_x, train_y, test_x,
                            test_y, seed, save, rules, log_every, device)


def _admm_l_demo(num_epochs, n_hiddens, train_x, train_y, test_x, test_y,
                 seed, save, rules, log_every, device):
    train_x, train_y = as_tensor(train_x, device), as_tensor(train_y, device)
    test_x, test_y = as_tensor(test_x, device), as_tensor(test_y, device)
    x_tm = train_x.transpose(0, 1).contiguous()
    wx, wh, wy = init_weights_like_reference(
        seed, train_x.shape[2], n_hiddens, train_y.shape[1], device=device)
    state = init_admm_l_state(wx, wh, wy, x_tm)

    # The initial loss from the seeded forward's `a` (main.py:133-137).
    params0 = _to_core_params(state.wx, state.wh, state.wy)
    loss_train = [float(torch.mean((train_y - state.a) ** 2))]
    loss_test = [float(mse_loss(params0, test_x, test_y))]
    info(f'Loss at the beginning: {loss_train[0]}')

    timer = Timer()
    timer.start()
    tl, vl = [], []
    for k in range(1, num_epochs + 1):
        state, (t_loss, v_loss) = epoch(state, x_tm, train_x, train_y,
                                        test_x, test_y, rules)
        tl.append(t_loss)
        vl.append(v_loss)
        if log_every and k % log_every == 0:
            info(f'ADMM-LSTM-L: k = {k}, loss train = {float(tl[-1])}, '
                 f'loss test = {float(vl[-1])}')
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    timer.pause()
    if tl:
        loss_train += torch.stack(tl).cpu().tolist()
        loss_test += torch.stack(vl).cpu().tolist()

    params = _to_core_params(state.wx, state.wh, state.wy)
    if save:
        from admm_lstm_torch.ckpt import save_model
        save_model('ADMM-LSTM-L', params)

    return {'name': 'ADMM-LSTM-L', 'train_loss': loss_train,
            'val_loss': loss_test, 'params': params, 'state': state,
            'seconds': timer.get_elapsed_time()}
