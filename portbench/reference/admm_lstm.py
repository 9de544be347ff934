"""Plain reference of Fast ADMM-LSTM training, the benchmark's yardstick.

A straightforward PyTorch implementation of the epoch that the
configurations state (the reference's Fast ADMM-LSTM, admm.py:62-78 of
Frederick2309/ADMM-LSTM, with the closed forms and line searches written
out), for one instance or for S instances on a leading axis (a rho
search).  It imports torch and numpy only: no kernel, no helper and no
module of the program it judges.  Every product runs in full float32 with
TF32 off (`fp32_matmuls`), except the exact stage's Gram at wide shapes,
whose operands the configuration rounds to bfloat16 (see `_gram`).

Layout: gate and dual slabs (S, T+1, H, B) with a zero row 0, `a`
(S, O, B), weights wx (S, 4, I, H), wh (S, 4, H, H), wy (S, H, O), gates
in i, f, g, o order; inputs x (T, I, B) and targets y (O, B), shared by
the S instances.

Two rule sets reach it (`Rules`): the default one (Gauss-Seidel sweep,
prox-linear weight stages with doubling line searches) and turbo()'s
(Jacobi sweep, exact Gauss-Newton weight stages with a Levenberg-
Marquardt anchor).  Both end each epoch with the prox-linear search of
the final hidden state, the output auxiliary `a` and the dual ascent.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

RHO_KEYS = ('i', 'f', 'g', 'o', 'c', 'h', 'y')
GATES = ('i', 'f', 'g', 'o')
# The exact stage's Gram runs on bf16-rounded operands above this many
# (columns x width x rows) elements, and in plain float32 at or below it
# (the configuration's rule, JAX normal_eq.py:35-40).
BF16_GRAM_MIN_ELEMS = 1 << 25
# Gram columns per product: keeps the (chunk, D, T*B) operand near 400 MB.
_GRAM_BUDGET_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class Rules:
    """What an epoch does.  sweep: 'gauss_seidel' or 'jacobi';
    exact_max_dim: weight stages of design width D <= this take the exact
    solve (0: every stage is prox-linear); bf16_gram: the exact stage's
    wide Grams take bf16 operands (matmul precision 'default')."""

    sweep: str = 'gauss_seidel'
    exact_max_dim: int = 0
    bf16_gram: bool = False
    h_theta0: float = 0.1
    h_theta_max: float = 1.0
    max_backtrack: int = 60
    wy_theta: float = 0.5
    wy_beta_factor: float = 1.0
    damping: float = 1e-6
    prox: float = 0.25


class State(NamedTuple):
    wx: torch.Tensor
    wh: torch.Tensor
    wy: torch.Tensor
    gates: Tuple[torch.Tensor, ...]     # i, f, g, o, c, h
    a: torch.Tensor
    duals: Tuple[torch.Tensor, ...]     # i, f, g, o, c, h
    rho: torch.Tensor                   # (S, 7) in RHO_KEYS order
    beta_x: torch.Tensor                # (4,) wi, wf, wg, wo
    beta_h: torch.Tensor                # (4,) vi, vf, vg, vo
    beta_wy: torch.Tensor               # 0-d


@contextlib.contextmanager
def fp32_matmuls():
    """Full float32 products (TF32 off) for the body."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- model

def _cell(pre, c):
    """One LSTM step from the (S, 4, H, B) pre-activations."""
    i = torch.sigmoid(pre[:, 0])
    f = torch.sigmoid(pre[:, 1])
    g = torch.tanh(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    c = f * c + i * g
    return i, f, g, o, c, o * torch.tanh(c)


def forward(wx, wh, x):
    """Gate histories (6 slabs (S, T+1, H, B), row 0 zero) of the LSTM
    over x (T, I, B)."""
    s, hidden, batch = wx.shape[0], wh.shape[-1], x.shape[-1]
    h = x.new_zeros((s, hidden, batch))
    c = torch.zeros_like(h)
    rows = [[h] for _ in range(6)]
    for x_t in x:
        pre = (torch.einsum('ib,sgih->sghb', x_t, wx)
               + torch.einsum('shb,sghk->sgkb', h, wh))
        out = _cell(pre, c)
        c, h = out[4], out[5]
        for acc, v in zip(rows, out):
            acc.append(v)
    return tuple(torch.stack(r, dim=1) for r in rows)


def losses(wx, wh, wy, x_all, y, vy):
    """(S,) train and validation mean squared errors: one forward over the
    train and validation inputs side by side along the batch."""
    h = forward(wx, wh, x_all)[5][:, -1]
    pred = torch.einsum('shb,sho->sob', h, wy)
    nb = y.shape[-1]
    return (((pred[..., :nb] - y) ** 2).mean(dim=(-2, -1)),
            ((pred[..., nb:] - vy) ** 2).mean(dim=(-2, -1)))


def init_state(wx, wh, wy, x, rho, beta) -> State:
    """Gates from a forward pass, duals zero.  rho (S, 7); beta a dict of
    the 9 ridge coefficients."""
    gates = forward(wx, wh, x)
    a = torch.einsum('shb,sho->sob', gates[5][:, -1], wy)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    return State(wx, wh, wy, gates, a,
                 tuple(torch.zeros_like(g) for g in gates), rho,
                 f32([beta['w' + k] for k in GATES]),
                 f32([beta['v' + k] for k in GATES]), f32(beta['wy']))


# ------------------------------------------------------- weight stages

def _gate_cols(hidden, device):
    """Per column of the gate-folded (4H) axis: act(x) = a + b tanh(s x)
    (sigmoid(x) = (1 + tanh(x/2)) / 2), act'(x) = c (1 - tanh(s x)^2)."""
    is_tanh = (torch.arange(4 * hidden, device=device) // hidden) == 2
    one = torch.ones(4 * hidden, device=device)
    s = torch.where(is_tanh, one, 0.5 * one)
    a = torch.where(is_tanh, 0.0 * one, 0.5 * one)
    c = torch.where(is_tanh, one, 0.25 * one)
    return (v[:, None] for v in (a, s, s, c))       # (4H, 1) each


def _rows_of(m):
    """The einsum subscripts of design rows shared by the instances
    (T, D, B) or of their own (S, T, D, B)."""
    return 'tdb' if m.dim() == 3 else 'stdb'


def _per_gate(v, hidden):
    return v.reshape(v.shape[:-1] + (4, hidden)).sum(-1)


def _cols(v, hidden):
    return torch.repeat_interleave(v, hidden, dim=-1)


def _prox_linear_stage(m, pre_self, pre_other, w, target, rho_g, beta_g,
                       rules):
    """One prox-linear weight stage (admm.py:282-343) for all four gates:
    m (T, D, B) or (S, T, D, B) design rows, w (S, D, 4H), slabs
    (S, T, 4H, B).  Returns (new w, m @ new w)."""
    steps = target.shape[1]
    hidden = w.shape[-1] // 4
    a_c, b_c, s_c, c_c = _gate_cols(hidden, w.device)
    act = lambda v: a_c + b_c * torch.tanh(s_c * v)
    pre = pre_self + pre_other
    u = torch.tanh(s_c * pre)
    resid = a_c + b_c * u - target
    d_act = c_c * (1.0 - u * u)
    rho_cols = _cols(rho_g, hidden)                          # (S, 4H)
    md = _rows_of(m)
    grad = rho_cols[:, None, :] * torch.einsum(
        f'{md},stkb->sdk', m, resid * d_act)
    grad_proj = torch.einsum(f'{md},sdk->stkb', m, grad)
    f_w = 0.5 * rho_g * _per_gate((resid * resid).sum(dim=(1, 3)), hidden)
    est = (1.0 + 0.5 * steps) * _per_gate((grad * grad).sum(dim=1), hidden)

    # Doubling line search per (instance, gate): the first theta in
    # 1, 2, 4, ... with f(W + grad/theta) <= f(W) + est/theta; where none
    # passes within max_backtrack tests, theta is 2^max_backtrack.
    theta = torch.ones_like(rho_g)
    searching = torch.ones(theta.shape, dtype=torch.bool, device=w.device)
    for _ in range(rules.max_backtrack):
        th = _cols(theta, hidden)[:, None, :, None]
        r = act(pre + grad_proj / th) - target
        f_new = 0.5 * rho_g * _per_gate((r * r).sum(dim=(1, 3)), hidden)
        searching = searching & (f_new > f_w + est / theta)
        if not bool(searching.any()):
            break
        theta = torch.where(searching, 2.0 * theta, theta)
    theta = theta / 2.0

    scale = 0.5 * rho_g * steps * theta
    sc, den = _cols(scale, hidden), _cols(beta_g + scale, hidden)
    new_w = (sc[:, None, :] * w - grad) / den[:, None, :]
    proj = (sc[:, None, :, None] * pre_self - grad_proj) / den[:, None, :, None]
    return new_w, proj


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _gram(s2, m, bf16):
    """G[s, k] = sum over rows n of s2[s, k, n] m[n] m[n]^T: s2 (S, K, N),
    m (D, N) or (S, D, N).  With bf16 the operands are rounded to bf16
    first, and the product s2 * m once more, as the configuration states;
    the products of bf16 values and their float32 sums are then exact in
    TF32, so the product may take the tensor cores without rounding."""
    n_s, n_k, n_rows = s2.shape
    dim = m.shape[-2]
    m = m.expand(n_s, dim, n_rows) if m.dim() == 2 else m
    if bf16:
        s2, m = _bf16(s2), _bf16(m)
    chunk = max(1, min(n_k, _GRAM_BUDGET_ELEMS // (dim * n_rows)))
    out = []
    for s in range(n_s):
        for k0 in range(0, n_k, chunk):
            a = s2[s, k0:k0 + chunk, None, :] * m[s, None]
            if bf16:
                a = _bf16(a)
                saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    g = a.reshape(-1, n_rows) @ m[s].T
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved
            else:
                g = a.reshape(-1, n_rows) @ m[s].T
            out.append(g.reshape(-1, dim, dim))
    return torch.cat(out).reshape(n_s, n_k, dim, dim)


def _exact_stage(m, pre, w, target, rho_g, beta_g, rules):
    """The exact Gauss-Newton ridge solve of one weight stage: per column
    k, with r = act - target and s = act' at the current pre-activations,
    G = sum s^2 m m^T, b = sum s r m,
    w+ = ((beta + mu) I + rho G)^-1 (rho (G w - b) + mu w),
    mu = prox * rho * trace(G) / D + damping."""
    n_s, steps, n_k, batch = pre.shape
    hidden = n_k // 4
    dim = m.shape[-2]
    a_c, _, s_c, c_c = _gate_cols(hidden, w.device)
    u = torch.tanh(s_c * pre)
    resid = a_c + s_c * u - target
    d_act = c_c * (1.0 - u * u)

    def rows(v):                       # (..., T, X, B) -> (..., X, T*B)
        return v.transpose(-3, -2).reshape(v.shape[:-3] + (v.shape[-2], -1))

    m_rows = rows(m)
    bf16 = (rules.bf16_gram
            and n_k * dim * steps * batch > BF16_GRAM_MIN_ELEMS)
    gram = _gram(rows(d_act * d_act), m_rows, bf16)         # (S, K, D, D)
    bvec = rows(d_act * resid) @ m_rows.transpose(-2, -1)   # (S, K, D)
    rho_c = _cols(rho_g, hidden)                            # (S, K)
    beta_c = _cols(beta_g, hidden).expand(n_s, n_k)
    mu = (rules.prox * rho_c * torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
          / dim + rules.damping)
    eye = torch.eye(dim, device=w.device)
    lhs = ((beta_c + mu)[..., None, None] * eye
           + rho_c[..., None, None] * gram)
    w_cols = w.transpose(-2, -1)                            # (S, K, D)
    rhs = (rho_c[..., None] * ((gram @ w_cols[..., None])[..., 0] - bvec)
           + mu[..., None] * w_cols)
    chol = torch.linalg.cholesky(lhs)
    new_cols = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    return new_cols.transpose(-2, -1)


def _weight_stage(m, pre_self, pre_other, w, target, rho_g, beta_g, rules,
                  need_proj):
    if rules.exact_max_dim and m.shape[-2] <= rules.exact_max_dim:
        new_w = _exact_stage(m, pre_self + pre_other, w, target, rho_g,
                             beta_g, rules)
        proj = (torch.einsum(f'{_rows_of(m)},sdk->stkb', m, new_w)
                if need_proj else None)
        return new_w, proj
    return _prox_linear_stage(m, pre_self, pre_other, w, target, rho_g,
                              beta_g, rules)


def _wide(w):
    """(S, 4, D, H) -> (S, D, 4H), gate-major columns."""
    s, _, d, h = w.shape
    return w.transpose(1, 2).reshape(s, d, 4 * h)


def _narrow(w, hidden):
    s, d, _ = w.shape
    return w.reshape(s, d, 4, hidden).transpose(1, 2)


# --------------------------------------------------------------- sweep

def _timestep(pre, old, lam, c_prev, r):
    """Primal i, f, g, o, c (Gauss-Seidel order within the step) and the
    five duals of one timestep (admm.py:345-351, 388-436, 512-530).  pre
    (S, 4, H, B); old, lam: the step's six slabs; r: rho, (S, 1, 1) each."""
    ri, rf, rg, ro, rc, rh = r[:6]
    act_i = torch.sigmoid(pre[:, 0])
    act_f = torch.sigmoid(pre[:, 1])
    act_g = torch.tanh(pre[:, 2])
    act_o = torch.sigmoid(pre[:, 3])
    _, f_o, g_o, _, c_o, h_o = old
    li, lf, lg, lo, lc, lh = lam
    i_n = -(li - ri * act_i + (rc * (f_o * c_prev - c_o) - lc) * g_o) / (
        ri + rc * g_o * g_o)
    f_n = -(lf - rf * act_f + (rc * (g_o * i_n - c_o) - lc) * c_prev) / (
        rf + rc * c_prev * c_prev)
    g_n = -(lg - rg * act_g + (rc * (f_n * c_prev - c_o) - lc) * i_n) / (
        rg + rc * i_n * i_n)
    tc_o = torch.tanh(c_o)
    o_n = -(lo - ro * act_o + (rh * (0.0 - h_o) - lh) * tc_o) / (
        ro + rh * tc_o * tc_o)
    # The cell state's prox-linear step; its line search always ends at
    # theta = 1/2 (the test compares f(c) with itself).
    grad_c = (tc_o * o_n - (h_o + lh / rh)) * o_n * (1.0 - tc_o * tc_o)
    c_n = (0.5 * c_o - grad_c
           - rc * (lc / rc - f_n * c_prev - i_n * g_n)) / (rc + 0.5)
    duals = (li + ri * (i_n - act_i), lf + rf * (f_n - act_f),
             lg + rg * (g_n - act_g), lo + ro * (o_n - act_o),
             lc + rc * (c_n - (f_n * c_prev + i_n * g_n)))
    return (i_n, f_n, g_n, o_n, c_n), duals


def final_h_tests(theta0: float, theta_max: float, max_iters: int) -> int:
    """How many thetas the final-h search tests at most: theta0 doubling
    in float32 until it reaches theta_max, at most max_iters."""
    theta, n = np.float32(theta0), 0
    while n < max_iters:
        n += 1
        theta = np.float32(theta * 2)
        if theta >= theta_max:
            break
    return n


def _final_h(h_old, o_n, tanh_c, lam_h, r_h, wy, a_old, r_y, rules):
    """Prox-linear step of h_T on the output fit (admm.py:439-487): the
    first theta in theta0, 2 theta0, ... (below theta_max) at which the
    probe's objective lies under its quadratic model, halved."""
    out = lambda v: torch.einsum('shb,sho->sob', v, wy)
    total = lambda v: v.sum(dim=(-2, -1), keepdim=True)
    hw0 = out(h_old)
    resid0 = hw0 - a_old
    grad = r_y * torch.einsum('sob,sho->shb', resid0, wy)
    f_h = 0.5 * r_y * total(resid0 * resid0)
    fixed = r_h * o_n * tanh_c - lam_h - grad
    fixed_out = out(fixed)
    theta = h_old.new_full((h_old.shape[0], 1, 1),
                           float(np.float32(rules.h_theta0)))
    searching = torch.ones(theta.shape, dtype=torch.bool, device=h_old.device)
    for _ in range(final_h_tests(rules.h_theta0, rules.h_theta_max,
                                 rules.max_backtrack)):
        probe = (theta * h_old + fixed) / (theta + r_h)
        r = (theta * hw0 + fixed_out) / (theta + r_h) - a_old
        diff = probe - h_old
        f_probe = 0.5 * r_y * total(r * r)
        model = f_h + total(grad * diff) + 0.5 * theta * total(diff * diff)
        searching = searching & (f_probe > model)
        theta = torch.where(searching, 2.0 * theta, theta)
    theta = theta / 2.0
    return (theta * h_old + fixed) / (theta + r_h)


def epoch(st: State, x, y, rules: Rules) -> State:
    """One ADMM epoch: wy, the eight gate weights (x side, then h side),
    the t = 1..T sweep with its duals, `a` and the h-dual at T."""
    n_s, steps1, hidden, batch = st.gates[0].shape
    steps = steps1 - 1
    rho = st.rho
    r = tuple(rho[:, j].reshape(n_s, 1, 1) for j in range(7))
    r_h, r_y = r[5], r[6]
    gates, duals = st.gates, st.duals

    # 1. Readout wy: one prox-linear step at theta = 1/2 (admm.py:246-280).
    h_last = gates[5][:, -1]
    resid = torch.einsum('shb,sho->sob', h_last, st.wy) - st.a
    grad = r_y * torch.einsum('shb,sob->sho', h_last, resid)
    theta = rules.wy_theta
    wy = (theta * st.wy - grad) / (theta + rules.wy_beta_factor * st.beta_wy)

    # 2. Gate weights: the x side, then the h side on the fresh x side.
    rr = rho.reshape(n_s, 7, 1, 1, 1)
    target = torch.cat([duals[j][:, 1:] / rr[:, j] + gates[j][:, 1:]
                        for j in range(4)], dim=-2)       # (S, T, 4H, B)
    h_hist = gates[5][:, :-1]
    wx_w, wh_w = _wide(st.wx), _wide(st.wh)
    xproj = torch.einsum('tdb,sdk->stkb', x, wx_w)
    hproj = torch.einsum('stdb,sdk->stkb', h_hist, wh_w)
    rho_g = rho[:, :4]
    wx_w, xproj = _weight_stage(x, xproj, hproj, wx_w, target, rho_g,
                                st.beta_x, rules, need_proj=True)
    wh_w, _ = _weight_stage(h_hist, hproj, xproj, wh_w, target, rho_g,
                            st.beta_h, rules, need_proj=False)
    wx, wh = _narrow(wx_w, hidden), _narrow(wh_w, hidden)

    # 3. Sweep over t = 1..T-1, then the final step at T.
    xp = torch.einsum('tdb,sgdh->stghb', x, wx)       # row t-1 feeds t
    rec = lambda h: torch.einsum('shb,sghk->sgkb', h, wh)
    new = [[] for _ in range(11)]
    h_prev = x.new_zeros((n_s, hidden, batch))
    c_prev = torch.zeros_like(h_prev)
    for t in range(1, steps):
        if rules.sweep == 'jacobi':      # the previous sweep's h, c at t-1
            h_prev, c_prev = gates[5][:, t - 1], gates[4][:, t - 1]
        prim, lam = _timestep(xp[:, t - 1] + rec(h_prev),
                              [g[:, t] for g in gates],
                              [d[:, t] for d in duals], c_prev, r)
        h_n = (r_h * prim[3] * torch.tanh(prim[4]) - duals[5][:, t]) / r_h
        for acc, v in zip(new, prim + (h_n,) + lam):
            acc.append(v)
        h_prev, c_prev = h_n, prim[4]
    if steps == 1:
        h_prev = c_prev = x.new_zeros((n_s, hidden, batch))
    old_t = [g[:, -1] for g in gates]
    lam_t = [d[:, -1] for d in duals]
    prim, lam = _timestep(xp[:, -1] + rec(h_prev), old_t, lam_t, c_prev, r)
    tanh_c = torch.tanh(prim[4])
    h_t = _final_h(old_t[5], prim[3], tanh_c, lam_t[5], r_h, wy, st.a, r_y,
                   rules)
    hw_t = torch.einsum('shb,sho->sob', h_t, wy)
    n_b = batch * r_y
    a = (2.0 * y + n_b * hw_t) / (2.0 + n_b)
    lam_h_t = lam_t[5] + r_h * (h_t - prim[3] * tanh_c)
    for acc, v in zip(new, prim + (h_t,) + lam):
        acc.append(v)

    zero = x.new_zeros((n_s, 1, hidden, batch))
    slab = lambda rows: torch.cat([zero, torch.stack(rows, dim=1)], dim=1)
    new_gates = tuple(slab(new[j]) for j in range(6))
    lam_h = duals[5].clone()            # rows t < T of the h-dual never move
    lam_h[:, -1] = lam_h_t
    new_duals = tuple(slab(new[6 + j]) for j in range(5)) + (lam_h,)
    return st._replace(wx=wx, wh=wh, wy=wy, gates=new_gates, a=a,
                       duals=new_duals)


# ------------------------------------------------------------ the jobs

def train_run(wx, wh, wy, x, y, x_all, vy, rho, beta, epochs: int,
              rules: Rules):
    """A training run of `epochs` epochs from weights without the leading
    axis: (train losses, validation losses, each epochs + 1 long with the
    initial losses first, and the final (wx, wh, wy))."""
    with fp32_matmuls():
        st = init_state(wx[None], wh[None], wy[None], x,
                        torch.as_tensor(rho, dtype=torch.float32,
                                        device=x.device)[None], beta)
        hist: List[torch.Tensor] = [torch.stack(
            losses(st.wx, st.wh, st.wy, x_all, y, vy))]
        for _ in range(epochs):
            st = epoch(st, x, y, rules)
            hist.append(torch.stack(losses(st.wx, st.wh, st.wy, x_all, y,
                                           vy)))
        table = torch.cat(hist, dim=1).cpu().numpy()      # (2, epochs + 1)
    return table[0], table[1], (st.wx[0], st.wh[0], st.wy[0])


def rho_search(wx, wh, wy, x, y, x_all, vy, base_rho, candidates, beta,
               epochs: int, rules: Rules):
    """Every rho candidate (N, 7) trained `epochs` epochs from the same
    weights and initial state (the forward pass under the base rho): the
    (N,) final train and validation losses."""
    with fp32_matmuls():
        st = init_state(wx[None], wh[None], wy[None], x,
                        torch.as_tensor(base_rho, dtype=torch.float32,
                                        device=x.device)[None], beta)
        n = len(candidates)
        grow = lambda v: v.expand((n,) + v.shape[1:]).contiguous()
        st = st._replace(
            wx=grow(st.wx), wh=grow(st.wh), wy=grow(st.wy),
            gates=tuple(map(grow, st.gates)), a=grow(st.a),
            duals=tuple(map(grow, st.duals)),
            rho=torch.as_tensor(np.asarray(candidates, np.float32),
                                device=x.device))
        for _ in range(epochs):
            st = epoch(st, x, y, rules)
        train, val = losses(st.wx, st.wh, st.wy, x_all, y, vy)
    return train.cpu().numpy(), val.cpu().numpy()
