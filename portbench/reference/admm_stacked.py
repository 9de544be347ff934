"""Plain reference of the stacked N-layer ADMM-LSTM, the yardstick of the
stacked configurations.

A straightforward PyTorch implementation of the epoch that the stacked
formulation states, for one instance or for S instances on a leading
axis (a rho search).  Layer k maps h_{k-1} to h_k (h_{-1} is the input
x), and a linear head reads the top layer's final h.  Every layer above
the first carries pre-activation auxiliaries z_k,t = wx_k h_{k-1,t} +
wh_k h_{k,t-1} (dual lam_z, penalty rho_z) with gate_k,t = act(z_k,t), so
that every solve between layers is quadratic:

  * layer 0 is the one-layer treatment (admm_lstm.py) whose weights take
    the exact Gauss-Newton ridge solve with the Levenberg-Marquardt
    anchor, x side then h side;
  * an upper layer's (wx, wh) take one joint ridge solve against its z
    targets, X = [h_{k-1,t}; h_{k,t-1}] shared by the four gates, damped
    towards the old weights by theta = the Gram's mean diagonal;
  * z takes one majorized prox-linear step against the gate fit, with
    the curvature bound rho_g (act'^2 + |resid| |act''|) from the largest
    residual of the previous epoch's (4, H, B) block;
  * h of a layer below the top is the ridge solve against the z above
    it, (rho_h I + rho_z sum_g wx_g wx_g^T) h = rho_h o tanh(c) - lam_h
    + rho_z sum_g wx_g (z + lam_z / rho_z - wh_g h_above,t-1);
  * the top layer's final h takes the one-layer output prox, then `a`
    and the h-dual at T.

Epoch order: wy, layer 0's weights, the upper layers' weights, then one
sweep over t, bottom-up within a step, the duals inside it.  The h duals
of the layers below the top never move; the top layer's moves at T only.

It imports torch, numpy and the one-layer reference only: no kernel, no
helper and no module of the program it judges.  Every product runs in
full float32 with TF32 off (`fp32_matmuls`), but the upper layers'
weight solve, which runs in float64: its Gram and right-hand side are
sums over the T*B rows, and in float32 their rounding would depend on
how a GEMM splits that sum, differently for one instance and for the
candidate axis; the program solves it in float64 for that reason, and so
does this reference.  Layer 0's Gram is built in column blocks per
instance (admm_lstm._gram), which keeps the reference beside the program
on one card at the published widths.

Layout: per layer k, gate and dual slabs (S, T+1, H_k, B) with a zero
row 0, weights wx_k (S, 4, D_k, H_k) (D_0 = I, D_k = H_{k-1}) and wh_k
(S, 4, H_k, H_k); z and lam_z of each upper layer (S, T+1, 4, H_k, B);
`a` (S, O, B); the head wy (S, H_top, O); gates in i, f, g, o order;
inputs x (T, I, B) and targets y (O, B), shared by the S instances.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import admm_lstm as one
from portbench.reference.admm_lstm import Rules, fp32_matmuls

RHO_KEYS = ('i', 'f', 'g', 'o', 'c', 'h', 'y', 'z')
# act(z) = a + b tanh(s z) per gate (sigmoid for i, f, o; tanh for g).
_IS_TANH = (False, False, True, False)


class State(NamedTuple):
    wx: Tuple[torch.Tensor, ...]        # per layer
    wh: Tuple[torch.Tensor, ...]
    wy: torch.Tensor                    # the head
    gates: Tuple[Tuple[torch.Tensor, ...], ...]   # per layer: i f g o c h
    duals: Tuple[Tuple[torch.Tensor, ...], ...]   # per layer: i f g o c h
    z: Tuple[torch.Tensor, ...]         # layers 1.. : (S, T+1, 4, H, B)
    z_dual: Tuple[torch.Tensor, ...]
    a: torch.Tensor
    rho: torch.Tensor                   # (S, 7) in RHO_KEYS[:7] order
    rho_z: torch.Tensor                 # (S,)
    beta_x: torch.Tensor                # (4,) wi, wf, wg, wo
    beta_h: torch.Tensor                # (4,) vi, vf, vg, vo
    beta_wy: torch.Tensor               # 0-d


# ---------------------------------------------------------------- model

def _pre(h_in, wx, h_prev, wh):
    """(S, 4, H, B) pre-activations from the input rows h_in ((D, B)
    shared or (S, D, B)) and the layer's previous h (S, H, B)."""
    inp = (torch.einsum('db,sgdh->sghb', h_in, wx) if h_in.dim() == 2
           else torch.einsum('sdb,sgdh->sghb', h_in, wx))
    return inp + torch.einsum('skb,sgkh->sghb', h_prev, wh)


def forward(wx, wh, x):
    """Every layer's gate history (6 slabs (S, T+1, H, B), row 0 zero)
    and every upper layer's pre-activations ((S, T+1, 4, H, B), row 0
    zero) over x (T, I, B), layer after layer."""
    n_s, batch = wx[0].shape[0], x.shape[-1]
    below = list(x)                     # the rows feeding the layer
    hists, pres = [], []
    for k in range(len(wx)):
        hidden = wh[k].shape[-1]
        h = x.new_zeros((n_s, hidden, batch))
        c = torch.zeros_like(h)
        rows = [[h] for _ in range(6)]
        pre_rows = [x.new_zeros((n_s, 4, hidden, batch))]
        for h_in in below:
            pre = _pre(h_in, wx[k], h, wh[k])
            out = one._cell(pre, c)
            c, h = out[4], out[5]
            for acc, v in zip(rows, out):
                acc.append(v)
            pre_rows.append(pre)
        hists.append(tuple(torch.stack(r, dim=1) for r in rows))
        if k:
            pres.append(torch.stack(pre_rows, dim=1))
        below = rows[5][1:]
    return hists, pres


def losses(wx, wh, wy, x_all, y, vy):
    """(S,) train and validation mean squared errors: one forward over the
    train and validation inputs side by side along the batch."""
    hists, _ = forward(wx, wh, x_all)
    pred = torch.einsum('shb,sho->sob', hists[-1][5][:, -1], wy)
    nb = y.shape[-1]
    return (((pred[..., :nb] - y) ** 2).mean(dim=(-2, -1)),
            ((pred[..., nb:] - vy) ** 2).mean(dim=(-2, -1)))


def init_state(wx, wh, wy, x, rho, beta) -> State:
    """Gates and z from a forward pass, every dual zero.  rho (S, 8) in
    RHO_KEYS order; beta a dict of the 9 ridge coefficients."""
    hists, pres = forward(wx, wh, x)
    a = torch.einsum('shb,sho->sob', hists[-1][5][:, -1], wy)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    return State(tuple(wx), tuple(wh), wy, tuple(hists),
                 tuple(tuple(torch.zeros_like(g) for g in hist)
                       for hist in hists),
                 tuple(pres), tuple(torch.zeros_like(p) for p in pres), a,
                 rho[:, :7].contiguous(), rho[:, 7].contiguous(),
                 f32([beta['w' + k] for k in one.GATES]),
                 f32([beta['v' + k] for k in one.GATES]), f32(beta['wy']))


# ------------------------------------------------------- weight stages

def _layer0_weights(st: State, x, rules: Rules):
    """Layer 0's exact Gauss-Newton stages, x side then h side on the
    fresh x side (admm_lstm._exact_stage)."""
    gates, duals = st.gates[0], st.duals[0]
    n_s, hidden = st.rho.shape[0], st.wh[0].shape[-1]
    rr = st.rho.reshape(n_s, 7, 1, 1, 1)
    target = torch.cat([duals[j][:, 1:] / rr[:, j] + gates[j][:, 1:]
                        for j in range(4)], dim=-2)        # (S, T, 4H, B)
    h_hist = gates[5][:, :-1]
    wx_w, wh_w = one._wide(st.wx[0]), one._wide(st.wh[0])
    xproj = torch.einsum('tdb,sdk->stkb', x, wx_w)
    hproj = torch.einsum('stdb,sdk->stkb', h_hist, wh_w)
    rho_g = st.rho[:, :4]
    wx_w = one._exact_stage(x, xproj + hproj, wx_w, target, rho_g,
                            st.beta_x, rules)
    xproj = torch.einsum('tdb,sdk->stkb', x, wx_w)
    wh_w = one._exact_stage(h_hist, xproj + hproj, wh_w, target, rho_g,
                            st.beta_h, rules)
    return one._narrow(wx_w, hidden), one._narrow(wh_w, hidden)


def _upper_weights(h_below, h_own, z, z_dual, wx, wh, rho_z, beta_x,
                   beta_h):
    """An upper layer's joint damped ridge solve, in float64: per gate g,
    min_W rho_z/2 sum_t,b ||W^T X - (z + lam_z/rho_z)||^2
    + 1/2 sum_d beta_d ||W_d||^2 + theta/2 ||W - W_old||^2, with X = the
    rows h_{k-1,t} (t = 1..T) over h_{k,t-1} and theta = mean diag of
    rho_z X X^T.  Returns float32 (wx, wh)."""
    f64 = lambda v: v.double()
    n_s, steps, d_below, batch = h_below.shape
    hidden = h_own.shape[-2]
    dim = d_below + hidden
    rows = torch.cat([f64(h_below), f64(h_own)], dim=-2)    # (S, T, D, B)
    rows = rows.transpose(1, 2).reshape(n_s, dim, steps * batch)
    rz = f64(rho_z)
    target = f64(z[:, 1:]) + f64(z_dual[:, 1:]) / rz.reshape(n_s, 1, 1, 1, 1)
    target = target.permute(0, 2, 3, 1, 4).reshape(n_s, 4 * hidden,
                                                   steps * batch)
    gram = rz[:, None, None] * (rows @ rows.transpose(1, 2))   # (S, D, D)
    rhs = rz[:, None, None] * (target @ rows.transpose(1, 2))  # (S, 4H, D)
    rhs = rhs.reshape(n_s, 4, hidden, dim).transpose(2, 3)  # (S, 4, D, H)
    theta = torch.diagonal(gram, dim1=1, dim2=2).sum(-1) / dim   # (S,)
    reg = torch.cat([f64(beta_x)[:, None].expand(4, d_below),
                     f64(beta_h)[:, None].expand(4, hidden)], dim=-1)
    eye = torch.eye(dim, dtype=torch.float64, device=rows.device)
    lhs = (gram[:, None] + torch.diag_embed(reg)[None]
           + theta[:, None, None, None] * eye)               # (S, 4, D, D)
    w_old = torch.cat([f64(wx), f64(wh)], dim=-2)            # (S, 4, D, H)
    sol = torch.linalg.solve(lhs, rhs + theta[:, None, None, None] * w_old)
    sol = sol.float()
    return sol[:, :, :d_below].contiguous(), sol[:, :, d_below:].contiguous()


# --------------------------------------------------------------- sweep

def _act(z):
    """The gates' activations of (S, 4, H, B) pre-activations, with their
    first derivatives."""
    sig, tanh = torch.sigmoid(z), torch.tanh(z)
    act = torch.stack([tanh[:, g] if _IS_TANH[g] else sig[:, g]
                       for g in range(4)], dim=1)
    d_act = torch.stack([1.0 - tanh[:, g] ** 2 if _IS_TANH[g]
                         else sig[:, g] * (1.0 - sig[:, g])
                         for g in range(4)], dim=1)
    return act, d_act


def _z_step(z_old, u, v, rho_g, rho_z, resid_max):
    """min_z rho_g/2 (u - act(z))^2 + rho_z/2 (z - v)^2 by one step
    linearized at z_old, with the curvature bound theta per gate:
    rho_g (1 + 0.8 r) for tanh, rho_g (1/16 + 0.1 r) for a sigmoid, r the
    block's largest |act(z_old) - u|.  Shapes (S, 4, H, B); rho_g
    (S, 4, 1, 1), rho_z and resid_max (S, 1, 1, 1)."""
    act, d_act = _act(z_old)
    grad = rho_g * (act - u) * d_act
    bound = torch.stack([1.0 + 0.8 * resid_max[:, 0] if _IS_TANH[g]
                         else 0.0625 + 0.1 * resid_max[:, 0]
                         for g in range(4)], dim=1)
    theta = rho_g * bound
    return (theta * z_old - grad + rho_z * v) / (theta + rho_z)


def epoch(st: State, x, y, rules: Rules) -> State:
    """One stacked ADMM epoch."""
    n = len(st.wx)
    top = n - 1
    n_s, steps1, _, batch = st.gates[0][0].shape
    steps = steps1 - 1
    r = tuple(st.rho[:, j].reshape(n_s, 1, 1) for j in range(7))
    r_h, r_y = r[5], r[6]
    rz = st.rho_z.reshape(n_s, 1, 1)
    rz4 = st.rho_z.reshape(n_s, 1, 1, 1)
    rho_g = st.rho[:, :4].reshape(n_s, 4, 1, 1)

    # 1. Readout wy: one prox-linear step at theta = 1/2.
    h_last = st.gates[top][5][:, -1]
    resid = torch.einsum('shb,sho->sob', h_last, st.wy) - st.a
    grad = r_y * torch.einsum('shb,sob->sho', h_last, resid)
    wy = ((rules.wy_theta * st.wy - grad)
          / (rules.wy_theta + rules.wy_beta_factor * st.beta_wy))

    # 2. Weights from the previous epoch's slabs.
    wx, wh = list(st.wx), list(st.wh)
    wx[0], wh[0] = _layer0_weights(st, x, rules)
    for k in range(1, n):
        wx[k], wh[k] = _upper_weights(
            st.gates[k - 1][5][:, 1:], st.gates[k][5][:, :-1], st.z[k - 1],
            st.z_dual[k - 1], st.wx[k], st.wh[k], st.rho_z, st.beta_x,
            st.beta_h)

    # 3. The sweep.  The h solve of layer k < top: the Cholesky factor
    # of rho_h I + rho_z sum_g wx_g wx_g^T of the layer above, once.
    chol = []
    for k in range(top):
        eye = torch.eye(wh[k].shape[-1], device=x.device)
        m = r_h * eye + rz * torch.einsum('sgdh,sgeh->sde', wx[k + 1],
                                          wx[k + 1])
        chol.append(torch.linalg.cholesky(m))
    # The gate targets u and the z steps' largest residuals per (S, t).
    u, resid_max = [None], [None]
    for k in range(1, n):
        g, d = st.gates[k], st.duals[k]
        u_k = (torch.stack(g[:4], dim=2)
               + torch.stack(d[:4], dim=2) / rho_g[:, None])
        act, _ = _act(st.z[k - 1].flatten(0, 1))
        act = act.reshape(u_k.shape)
        u.append(u_k)
        resid_max.append((act - u_k).abs().amax(dim=(2, 3, 4)))   # (S, T+1)

    x_rows = list(x)
    new_g = [[[] for _ in range(6)] for _ in range(n)]
    new_d = [[[] for _ in range(5)] for _ in range(n)]
    new_z = [[] for _ in range(1, n)]
    new_zd = [[] for _ in range(1, n)]
    h_prev = [st.gates[k][5][:, 0] for k in range(n)]
    c_prev = [st.gates[k][4][:, 0] for k in range(n)]
    for t in range(1, steps + 1):
        h_new, c_new = [None] * n, [None] * n
        prims = [None] * n
        for k in range(n):
            old = [g[:, t] for g in st.gates[k]]
            lam = [d[:, t] for d in st.duals[k]]
            if k == 0:
                pre = _pre(x_rows[t - 1], wx[0], h_prev[0], wh[0])
            else:
                lin = _pre(h_new[k - 1], wx[k], h_prev[k], wh[k])
                z_t, zd_t = st.z[k - 1][:, t], st.z_dual[k - 1][:, t]
                pre = _z_step(z_t, u[k][:, t], lin - zd_t / rz4, rho_g, rz4,
                              resid_max[k][:, t].reshape(n_s, 1, 1, 1))
                new_z[k - 1].append(pre)
                new_zd[k - 1].append(zd_t + rz4 * (pre - lin))
            # act(z_new) of an upper layer is the one-layer step's act(pre)
            prim, duals = one._timestep(pre, old, lam, c_prev[k], r)
            prims[k] = prim
            for acc, v in zip(new_d[k], duals):
                acc.append(v)
            o_n, c_n = prim[3], prim[4]
            if k < top:
                above = torch.einsum('skb,sgkh->sghb', h_prev[k + 1],
                                     wh[k + 1])
                tgt = (st.z[k][:, t] + st.z_dual[k][:, t] / rz4 - above)
                rhs = (r_h * o_n * torch.tanh(c_n) - lam[5]
                       + rz * torch.einsum('sgdh,sghb->sdb', wx[k + 1], tgt))
                h_new[k] = torch.cholesky_solve(rhs, chol[k])
            elif t < steps:
                h_new[k] = (r_h * o_n * torch.tanh(c_n) - lam[5]) / r_h
            c_new[k] = c_n
        if t < steps:
            for k in range(n):
                for acc, v in zip(new_g[k], prims[k] + (h_new[k],)):
                    acc.append(v)
            h_prev, c_prev = h_new, c_new

    # The top layer's final h, then a and its h-dual at T.
    o_t, tanh_c = prims[top][3], torch.tanh(prims[top][4])
    h_t = one._final_h(st.gates[top][5][:, -1], o_t, tanh_c,
                       st.duals[top][5][:, -1], r_h, wy, st.a, r_y, rules)
    h_new[top] = h_t
    for k in range(n):
        for acc, v in zip(new_g[k], prims[k] + (h_new[k],)):
            acc.append(v)
    hw_t = torch.einsum('shb,sho->sob', h_t, wy)
    n_b = batch * r_y
    a = (2.0 * y + n_b * hw_t) / (2.0 + n_b)

    def slab(rows):
        zero = torch.zeros_like(rows[0])[:, None]
        return torch.cat([zero, torch.stack(rows, dim=1)], dim=1)

    gates, duals = [], []
    for k in range(n):
        gates.append(tuple(slab(new_g[k][j]) for j in range(6)))
        lam_h = st.duals[k][5]
        if k == top:                 # rows t < T never move
            lam_h = lam_h.clone()
            lam_h[:, -1] = lam_h[:, -1] + r_h * (h_t - o_t * tanh_c)
        duals.append(tuple(slab(new_d[k][j]) for j in range(5)) + (lam_h,))
    return st._replace(wx=tuple(wx), wh=tuple(wh), wy=wy,
                       gates=tuple(gates), duals=tuple(duals),
                       z=tuple(slab(v) for v in new_z),
                       z_dual=tuple(slab(v) for v in new_zd), a=a)


# ------------------------------------------------------------ the jobs

def _layers(weights: Sequence[torch.Tensor]):
    """(wx per layer, wh per layer, the head wy) of the program's weight
    tuple (wx_0, wh_0, wy_0, wx_1, ..., wy_head), each given a leading
    axis of one; the layers' own wy are unused."""
    n = (len(weights) - 1) // 3
    return ([weights[3 * k][None] for k in range(n)],
            [weights[3 * k + 1][None] for k in range(n)], weights[-1][None])


def train_run(weights, x, y, x_all, vy, rho, beta, epochs: int,
              rules: Rules):
    """A training run of `epochs` epochs from the weight tuple: (train
    losses, validation losses, each epochs + 1 long with the initial
    losses first, and the final weight tuple)."""
    with fp32_matmuls():
        wx, wh, wy = _layers(weights)
        st = init_state(wx, wh, wy, x, torch.as_tensor(
            rho, dtype=torch.float32, device=x.device)[None], beta)
        hist: List[torch.Tensor] = [torch.stack(
            losses(st.wx, st.wh, st.wy, x_all, y, vy))]
        for _ in range(epochs):
            st = epoch(st, x, y, rules)
            hist.append(torch.stack(losses(st.wx, st.wh, st.wy, x_all, y,
                                           vy)))
        table = torch.cat(hist, dim=1).cpu().numpy()      # (2, epochs + 1)
    n = len(st.wx)
    final = []
    for k in range(n):
        final += [st.wx[k][0], st.wh[k][0], weights[3 * k + 2]]
    return table[0], table[1], tuple(final) + (st.wy[0],)


def rho_search(weights, x, y, x_all, vy, candidates, beta, epochs: int,
               rules: Rules):
    """Every candidate (N, 8) in RHO_KEYS order trained `epochs` epochs
    from the same weights and initial state (the forward pass): the (N,)
    final train and validation losses."""
    with fp32_matmuls():
        wx, wh, wy = _layers(weights)
        cand = torch.as_tensor(np.asarray(candidates, np.float32),
                               device=x.device)
        st = init_state(wx, wh, wy, x, cand[:1], beta)
        n = len(cand)
        grow = lambda v: v.expand((n,) + v.shape[1:]).contiguous()
        st = st._replace(
            wx=tuple(map(grow, st.wx)), wh=tuple(map(grow, st.wh)),
            wy=grow(st.wy),
            gates=tuple(tuple(map(grow, g)) for g in st.gates),
            duals=tuple(tuple(map(grow, d)) for d in st.duals),
            z=tuple(map(grow, st.z)), z_dual=tuple(map(grow, st.z_dual)),
            a=grow(st.a), rho=cand[:, :7].contiguous(),
            rho_z=cand[:, 7].contiguous())
        for _ in range(epochs):
            st = epoch(st, x, y, rules)
        train, val = losses(st.wx, st.wh, st.wy, x_all, y, vy)
    return train.cpu().numpy(), val.cpu().numpy()
