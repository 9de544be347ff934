"""The fused interior timestep sweep of the fast ADMM epoch: a hand-written
CUDA kernel for Hopper and its plain PyTorch version.

Replaces `admm_lstm_tpu/kernels/gate_sweep.py::pallas_interior_sweep`,
with the same argument and return contract.  For t = 1..T-1, serially in
time and independently per batch column: the recurrent pre-activations
pre_g = xproj[t, g] + wh[g]^T h_{t-1}, the closed forms for i, f, g, o,
the c prox-linear step (theta = 1/2), the interior h, and the five dual
ascents i, f, g, o, c, with h_0 = c_0 = 0.

`interior_sweep` launches the kernel (csrc/gate_sweep.cu) for CUDA
tensors and raises on anything it cannot take; it runs the plain version
only for tensors that lie on the CPU.  There is no fallback from the
kernel to the plain version.  What bounds the kernel on an H100 (bytes:
about 38 MB of slab traffic at GoogleStock) and how its design answers
that is written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

Slabs = Tuple[torch.Tensor, ...]

_LIB = 'gate_sweep'


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
    ri, rf, rg, ro, rc, rh = rho_vec.unbind()
    steps, _, hidden, batch = xproj.shape
    h_prev = xproj.new_zeros((hidden, batch))
    c_prev = xproj.new_zeros((hidden, batch))
    outs = [[] for _ in range(11)]
    for t in range(steps):
        pre = xproj[t] + torch.einsum('hb,ghk->gkb', h_prev, wh)
        act_i = torch.sigmoid(pre[0])
        act_f = torch.sigmoid(pre[1])
        act_g = torch.tanh(pre[2])
        act_o = torch.sigmoid(pre[3])
        _, f_o, g_o, _, c_o, h_o = (s[t] for s in gates)
        li, lf, lg, lo, lc, lh = (s[t] for s in duals)
        cp = c_prev

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

        step = (i_n, f_n, g_n, o_n, c_n, h_n,
                li + ri * (i_n - act_i), lf + rf * (f_n - act_f),
                lg + rg * (g_n - act_g), lo + ro * (o_n - act_o),
                lc + rc * (c_n - (f_n * cp + i_n * g_n)))
        for acc, v in zip(outs, step):
            acc.append(v)
        h_prev, c_prev = h_n, c_n
    stacked = tuple(torch.stack(o) for o in outs)
    return stacked[:6], stacked[6:]


def _check(xproj, wh, gates, duals, rho_vec):
    if len(gates) != 6 or len(duals) != 6:
        raise ValueError(f'need 6 gate and 6 dual slabs, got {len(gates)} '
                         f'and {len(duals)}')
    if xproj.dim() != 4 or xproj.shape[1] != 4:
        raise ValueError(f'xproj must be (T-1, 4, H, B), got {tuple(xproj.shape)}')
    steps, _, hidden, batch = xproj.shape
    tensors = (xproj, wh, rho_vec, *gates, *duals)
    if any(t.device != xproj.device for t in tensors):
        raise ValueError('interior_sweep: all inputs must be on one device')
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError('interior_sweep: every input must be float32')
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError('interior_sweep: every input must be contiguous')
    if tuple(wh.shape) != (4, hidden, hidden):
        raise ValueError(f'wh must be (4, {hidden}, {hidden}), '
                         f'got {tuple(wh.shape)}')
    if tuple(rho_vec.shape) != (6,):
        raise ValueError(f'rho_vec must be (6,), got {tuple(rho_vec.shape)}')
    for s in (*gates, *duals):
        if tuple(s.shape) != (steps, hidden, batch):
            raise ValueError(f'slabs must be ({steps}, {hidden}, {batch}), '
                             f'got {tuple(s.shape)}')
    if steps < 1 or batch < 1 or hidden < 1:
        raise ValueError(f'empty sweep: steps {steps}, H {hidden}, B {batch}')


def _library():
    from admm_lstm_torch.kernels.build import load_library
    lib = load_library(_LIB)
    fn = lib.gate_sweep_interior
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


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
    if xproj.device.type != 'cuda':
        raise ValueError(f'interior_sweep runs on CUDA or the CPU, not '
                         f'{xproj.device}')
    steps, _, hidden, batch = xproj.shape
    fn = _library()
    outs = [torch.empty((steps, hidden, batch), dtype=torch.float32,
                        device=xproj.device) for _ in range(11)]
    ins_arr = (ctypes.c_void_p * 12)(*(s.data_ptr() for s in (*gates, *duals)))
    outs_arr = (ctypes.c_void_p * 11)(*(o.data_ptr() for o in outs))
    with torch.cuda.device(xproj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xproj.data_ptr(), wh.data_ptr(), rho_vec.data_ptr(),
                 ins_arr, outs_arr, steps, hidden, batch, stream)
    if err != 0:
        raise RuntimeError(f'gate_sweep_interior launch failed: CUDA error '
                           f'{err} (steps {steps}, H {hidden}, B {batch})')
    interior_sweep.launches += 1
    return tuple(outs[:6]), tuple(outs[6:])


interior_sweep.launches = 0
