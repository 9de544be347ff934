"""The fused interior timestep sweeps of the fast ADMM epoch: hand-written
CUDA kernels for Hopper and their plain PyTorch versions.

`interior_sweep` replaces
`admm_lstm_tpu/kernels/gate_sweep.py::pallas_interior_sweep`, with the
same argument and return contract.  For t = 1..T-1, serially in time and
independently per batch column: the recurrent pre-activations
pre_g = xproj[t, g] + wh[g]^T h_{t-1}, the closed forms for i, f, g, o,
the c prox-linear step (theta = 1/2), the interior h, and the five dual
ascents i, f, g, o, c, with h_0 = c_0 = 0.

`jacobi_sweep` replaces `::pallas_jacobi_sweep`: the same per-timestep
math for every interior t at once, from the previous sweep's c[t-1] and a
pre-activation whose recurrent product the caller hoisted out, so every
element is independent.

Both wrappers launch their kernel (csrc/gate_sweep.cu) for CUDA tensors
and raise on anything they cannot take; they run the plain version only
for tensors that lie on the CPU.  There is no fallback from a kernel to
its plain version.  What bounds the kernels on an H100 (bytes: about
38 MB of slab traffic per sweep at GoogleStock) and how their design
answers that is written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from admm_lstm_torch.kernels.build import launch

Slabs = Tuple[torch.Tensor, ...]

_LIB = 'gate_sweep'


def _timestep_plain(pre, old, lams, cp, rho_vec):
    """One interior timestep (or, broadcast over a leading axis, all of
    them) in `_timestep_math`'s order: the four pre-activations, the six
    old gate and six dual blocks, and c_{t-1} -> (i, f, g, o, c, h and the
    duals i, f, g, o, c)."""
    ri, rf, rg, ro, rc, rh = rho_vec.unbind()
    act_i = torch.sigmoid(pre[0])
    act_f = torch.sigmoid(pre[1])
    act_g = torch.tanh(pre[2])
    act_o = torch.sigmoid(pre[3])
    _, f_o, g_o, _, c_o, h_o = old
    li, lf, lg, lo, lc, lh = lams

    i_n = -(li - ri * act_i + (rc * (f_o * cp - c_o) - lc) * g_o) / (
        ri + rc * g_o * g_o)
    f_n = -(lf - rf * act_f + (rc * (g_o * i_n - c_o) - lc) * cp) / (
        rf + rc * cp * cp)
    g_n = -(lg - rg * act_g + (rc * (f_n * cp - c_o) - lc) * i_n) / (
        rg + rc * i_n * i_n)
    tc_o = torch.tanh(c_o)
    o_n = -(lo - ro * act_o + (rh * (0.0 - h_o) - lh) * tc_o) / (
        ro + rh * tc_o * tc_o)
    z = h_o + lh / rh
    grad_c = (tc_o * o_n - z) * o_n * (1.0 - tc_o * tc_o)
    a_term = lc / rc - f_n * cp - i_n * g_n
    c_n = (0.5 * c_o - grad_c - rc * a_term) / (rc + 0.5)
    h_n = (rh * o_n * torch.tanh(c_n) - lh) / rh

    return (i_n, f_n, g_n, o_n, c_n, h_n,
            li + ri * (i_n - act_i), lf + rf * (f_n - act_f),
            lg + rg * (g_n - act_g), lo + ro * (o_n - act_o),
            lc + rc * (c_n - (f_n * cp + i_n * g_n)))


def interior_sweep_plain(xproj: torch.Tensor, wh: torch.Tensor,
                         gates: Sequence[torch.Tensor],
                         duals: Sequence[torch.Tensor],
                         rho_vec: torch.Tensor) -> Tuple[Slabs, Slabs]:
    """The plain PyTorch version: a loop over t mirroring the scan body of
    `admm_lstm_tpu/core/step.py:357-371` in `_timestep_math`'s order.

    Args:
      xproj:   (T-1, 4, H, B) input projections for t = 1..T-1.
      wh:      (4, H, H) recurrent weights.
      gates:   6 slabs (T-1, H, B): old i, f, g, o, c, h.
      duals:   6 slabs (T-1, H, B): lambda i, f, g, o, c, h.
      rho_vec: (6,) rho i, f, g, o, c, h.
    Returns:
      (6 new gate slabs i..h, 5 new dual slabs i..c), each (T-1, H, B).
    """
    steps, _, hidden, batch = xproj.shape
    h_prev = xproj.new_zeros((hidden, batch))
    c_prev = xproj.new_zeros((hidden, batch))
    outs = [[] for _ in range(11)]
    for t in range(steps):
        pre = xproj[t] + torch.einsum('hb,ghk->gkb', h_prev, wh)
        step = _timestep_plain(pre, [s[t] for s in gates],
                               [s[t] for s in duals], c_prev, rho_vec)
        for acc, v in zip(outs, step):
            acc.append(v)
        h_prev, c_prev = step[5], step[4]
    stacked = tuple(torch.stack(o) for o in outs)
    return stacked[:6], stacked[6:]


def jacobi_sweep_plain(pre: torch.Tensor, gates: Sequence[torch.Tensor],
                       duals: Sequence[torch.Tensor], h_prev: torch.Tensor,
                       c_prev: torch.Tensor,
                       rho_vec: torch.Tensor) -> Tuple[Slabs, Slabs]:
    """The plain PyTorch version of `jacobi_sweep`, the vmapped Jacobi
    block of `admm_lstm_tpu/core/step.py:417-427` as one broadcast pass.

    Args:
      pre:     (T-1, 4, H, B) full pre-activations (input projection plus
               the hoisted recurrent projection of the previous sweep's h).
      gates:   6 slabs (T-1, H, B): old i, f, g, o, c, h.
      duals:   6 slabs (T-1, H, B): lambda i, f, g, o, c, h.
      h_prev:  (T-1, H, B) previous sweep's h[t-1]; already inside `pre`,
               so the math does not read it.
      c_prev:  (T-1, H, B) previous sweep's c[t-1].
      rho_vec: (6,) rho i, f, g, o, c, h.
    Returns:
      (6 new gate slabs i..h, 5 new dual slabs i..c), each (T-1, H, B).
    """
    del h_prev
    out = _timestep_plain(pre.unbind(1), gates, duals, c_prev, rho_vec)
    return tuple(out[:6]), tuple(out[6:])


def _check_slabs(name, tensors, slabs, steps, hidden, batch):
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f'{name}: all inputs must be on one device')
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f'{name}: every input must be float32')
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f'{name}: every input must be contiguous')
    for s in slabs:
        if tuple(s.shape) != (steps, hidden, batch):
            raise ValueError(f'slabs must be ({steps}, {hidden}, {batch}), '
                             f'got {tuple(s.shape)}')
    if steps < 1 or batch < 1 or hidden < 1:
        raise ValueError(f'empty sweep: steps {steps}, H {hidden}, B {batch}')
    if tensors[0].device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on CUDA or the CPU, not '
                         f'{tensors[0].device}')


def _check_common(name, proj, gates, duals, rho_vec):
    if len(gates) != 6 or len(duals) != 6:
        raise ValueError(f'need 6 gate and 6 dual slabs, got {len(gates)} '
                         f'and {len(duals)}')
    if proj.dim() != 4 or proj.shape[1] != 4:
        raise ValueError(f'{name}: the projection must be (T-1, 4, H, B), '
                         f'got {tuple(proj.shape)}')
    if tuple(rho_vec.shape) != (6,):
        raise ValueError(f'rho_vec must be (6,), got {tuple(rho_vec.shape)}')


def _check(xproj, wh, gates, duals, rho_vec):
    _check_common('interior_sweep', xproj, gates, duals, rho_vec)
    steps, _, hidden, batch = xproj.shape
    if tuple(wh.shape) != (4, hidden, hidden):
        raise ValueError(f'wh must be (4, {hidden}, {hidden}), '
                         f'got {tuple(wh.shape)}')
    _check_slabs('interior_sweep', (xproj, wh, rho_vec, *gates, *duals),
                 (*gates, *duals), steps, hidden, batch)


def _launch(symbol, first, second, rho_vec, gates, duals):
    """Allocates the 11 outputs and launches `symbol` on the current
    stream of the inputs' card."""
    steps, _, hidden, batch = first.shape
    outs = [torch.empty((steps, hidden, batch), dtype=torch.float32,
                        device=first.device) for _ in range(11)]
    ins_arr = (ctypes.c_void_p * 12)(*(s.data_ptr() for s in (*gates, *duals)))
    outs_arr = (ctypes.c_void_p * 11)(*(o.data_ptr() for o in outs))
    vp = ctypes.c_void_p
    launch(_LIB, symbol,
           [vp, vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
            ctypes.c_int, ctypes.c_int, ctypes.c_int], first.device,
           first.data_ptr(), second.data_ptr(), rho_vec.data_ptr(), ins_arr,
           outs_arr, steps, hidden, batch,
           detail=f'steps {steps}, H {hidden}, B {batch}')
    return tuple(outs[:6]), tuple(outs[6:])


def interior_sweep(xproj: torch.Tensor, wh: torch.Tensor,
                   gates: Sequence[torch.Tensor],
                   duals: Sequence[torch.Tensor],
                   rho_vec: torch.Tensor) -> Tuple[Slabs, Slabs]:
    """Interior timesteps t = 1..T-1 of the Gauss-Seidel sweep.

    Same arguments and returns as `interior_sweep_plain`.  CUDA tensors go
    to the CUDA kernel (which adds one to `interior_sweep.launches` per
    launch); CPU tensors go to the plain version.
    """
    _check(xproj, wh, gates, duals, rho_vec)
    if xproj.device.type == 'cpu':
        return interior_sweep_plain(xproj, wh, gates, duals, rho_vec)
    out = _launch('gate_sweep_interior', xproj, wh, rho_vec, gates, duals)
    interior_sweep.launches += 1
    return out


def jacobi_sweep(pre: torch.Tensor, gates: Sequence[torch.Tensor],
                 duals: Sequence[torch.Tensor], h_prev: torch.Tensor,
                 c_prev: torch.Tensor,
                 rho_vec: torch.Tensor) -> Tuple[Slabs, Slabs]:
    """Every interior timestep of the Jacobi sweep at once.

    Same arguments and returns as `jacobi_sweep_plain`.  CUDA tensors go
    to the CUDA kernel (which adds one to `jacobi_sweep.launches` per
    launch); CPU tensors go to the plain version.
    """
    _check_common('jacobi_sweep', pre, gates, duals, rho_vec)
    steps, _, hidden, batch = pre.shape
    _check_slabs('jacobi_sweep',
                 (pre, rho_vec, h_prev, c_prev, *gates, *duals),
                 (h_prev, c_prev, *gates, *duals), steps, hidden, batch)
    if pre.device.type == 'cpu':
        return jacobi_sweep_plain(pre, gates, duals, h_prev, c_prev, rho_vec)
    out = _launch('gate_sweep_jacobi', pre, c_prev, rho_vec, gates, duals)
    jacobi_sweep.launches += 1
    return out


interior_sweep.launches = 0
jacobi_sweep.launches = 0
