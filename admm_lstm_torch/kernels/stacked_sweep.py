"""The stacked variant's sweep over t and the layers as one hand-written
CUDA kernel for Hopper, with the z step's curvature bounds in a pass
before it.

`stacked_sweep` replaces no TPU kernel: the JAX package runs the sweep as
a `lax.scan` (`admm_lstm_tpu/variants/stacked.py`) that XLA fuses.  Its
plain version is `variants/stacked.py::stacked_sweep_plain`, the loop that
the epoch runs on the CPU; the kernel (csrc/stacked_sweep.cu, which says
what bounds it and how its design answers that) computes the same new
slabs in one launch, and `stacked_resmax_kernel` the bounds in one pass.

`stacked_sweep_plan` decides whether a stack fits the kernel: its
per-candidate products (every layer's wh and wx, each M^-1) and each
block's column buffers have to fit a block's shared memory.
`use_stacked_kernel` is the epoch's choice, from what it can observe: CUDA
tensors, FP32 products ('highest'; under TF32 the epoch's other products
would not be the kernel's) and a plan.  `stacked_sweep` launches the
kernel and raises on what it cannot take; there is no fallback to the
plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from admm_lstm_torch.kernels.build import launch

_LIB = 'stacked_sweep'

# csrc/stacked_sweep.cu MIN_LAYERS, MAX_LAYERS, MAX_THREADS and
# RESMAX_THREADS.
MIN_LAYERS = 2
MAX_LAYERS = 3
MAX_THREADS = 320
RESMAX_THREADS = 256
# Dynamic shared memory a block may ask for on an H100 (227 KB).
SMEM_PER_BLOCK = 232448
# (rows a thread, columns a block), tried in order: the first whose block
# of tb * ceil(H / rows) threads stays within MAX_THREADS.
_SHAPES = ((1, 32), (1, 16), (2, 16), (4, 16))


class SweepPlan(NamedTuple):
    """The launch: `tb` columns and `threads` threads a block, `rows`
    hidden rows a thread, `smem` bytes of dynamic shared memory, the
    offsets (floats) of the packed weights and of the column buffers."""
    tb: int
    rows: int
    threads: int
    smem: int
    w_floats: int
    rec: Tuple[int, ...]      # per layer: wh_k as [d][j][g]
    inp: Tuple[int, ...]      # per layer: wx_k as [d][j][g]
    minv: Tuple[int, ...]     # per layer below the top: M_k^-1; -1 on top
    hbuf: Tuple[int, ...]     # per layer: the [H][tb] h buffer
    tgt: int
    rhs: int


def stacked_sweep_plan(hiddens: Sequence[int],
                       inputs: int) -> Optional[SweepPlan]:
    """The kernel's plan for a stack of `hiddens` widths on `inputs`
    input features, or None where the stack does not fit it: fewer than
    MIN_LAYERS or more than MAX_LAYERS layers, a layer wider than
    4 * MAX_THREADS / 16 rows, or weights and buffers past a block's
    shared memory."""
    hiddens = tuple(int(h) for h in hiddens)
    n = len(hiddens)
    if not MIN_LAYERS <= n <= MAX_LAYERS or min(hiddens) < 1 or inputs < 1:
        return None
    hmax = max(hiddens)
    for rows, tb in _SHAPES:
        threads = tb * -(-hmax // rows)
        if threads <= MAX_THREADS:
            break
    else:
        return None
    off, rec, inp = 0, [], []
    for k, h in enumerate(hiddens):
        rec.append(off)
        off += 4 * h * h
        inp.append(off)
        off += 4 * (inputs if k == 0 else hiddens[k - 1]) * h
    minv = []
    for h in hiddens[:-1]:
        minv.append(off)
        off += h * h
    minv.append(-1)
    w_floats = -(-off // 4) * 4
    off, hbuf = w_floats, []
    for h in hiddens:
        hbuf.append(off)
        off += h * tb
    tgt = off
    off += 4 * max(hiddens[1:]) * tb
    rhs = off
    off += max(hiddens[:-1]) * tb
    smem = 4 * off
    if smem > SMEM_PER_BLOCK:
        return None
    return SweepPlan(tb, rows, threads, smem, w_floats, tuple(rec),
                     tuple(inp), tuple(minv), tuple(hbuf), tgt, rhs)


def use_stacked_kernel(device_type: str, precision: str,
                       plan: Optional[SweepPlan]) -> bool:
    """Whether the stacked epoch runs the kernel: CUDA tensors, the
    'highest' matmul precision and a plan."""
    return device_type == 'cuda' and precision == 'highest' and \
        plan is not None


def pack_weights(layers, m_invs: Sequence[torch.Tensor],
                 plan: SweepPlan) -> torch.Tensor:
    """Each candidate's weights as one row of plan.w_floats floats
    ((S, w) with the candidate axis, else (1, w)): per layer wh then wx as
    [d][j][g], then each M^-1 as [j][d], zero-padded."""
    lead = layers[0].wh.shape[:-3]
    rows = lead[0] if lead else 1

    def flat(w):
        return w.reshape(rows, -1)

    parts = []
    for lp in layers:
        parts += [flat(lp.wh.movedim(-3, -1)), flat(lp.wx.movedim(-3, -1))]
    parts += [flat(m) for m in m_invs]
    used = sum(p.shape[1] for p in parts)
    if used < plan.w_floats:
        parts.append(layers[0].wh.new_zeros((rows, plan.w_floats - used)))
    return torch.cat(parts, dim=1)


def _strides(t: torch.Tensor, trailing: int) -> Tuple[int, int]:
    """A slab's candidate and time strides in floats (0 for the candidate
    without the axis), for slabs whose last `trailing` axes follow time."""
    lead = t.dim() - 1 - trailing
    return (t.stride(0) if lead else 0), t.stride(lead)


def _check_slab(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                trailing: int):
    """float32 on CUDA, of `shape`, its last `trailing` axes (those after
    time) contiguous."""
    if t.dtype != torch.float32 or t.device.type != 'cuda':
        raise TypeError(f'stacked_sweep: {name} must be float32 on CUDA, got '
                        f'{t.dtype} on {t.device}')
    if tuple(t.shape) != shape:
        raise ValueError(f'stacked_sweep: {name} has shape '
                         f'{tuple(t.shape)}, expected {shape}')
    want = [math.prod(shape[len(shape) - i:]) for i in range(trailing)]
    if list(t.stride()[-trailing:]) != want[::-1]:
        raise ValueError(f'stacked_sweep: {name} must be contiguous after '
                         f'its time axis, got strides {t.stride()}')


def rho_pack(rho, rho_z: torch.Tensor) -> torch.Tensor:
    """The kernels' penalties: rho i, f, g, o, c, h and rho_z, (7,), or
    (S, 7) where one of them is per candidate."""
    return torch.stack(torch.broadcast_tensors(
        rho.i, rho.f, rho.g, rho.o, rho.c, rho.h, rho_z), dim=-1).to(
            torch.float32).contiguous()


def stacked_resmax(z: torch.Tensor, gates, duals, rhos: torch.Tensor,
                   out: torch.Tensor) -> None:
    """stacked_resmax_kernel for one upper layer into `out` ((S, T+1)
    int32, zero, read as float bits): z ([S,] T+1, 4, H, B), `gates` and
    `duals` that layer's i, f, g, o ([S,] T+1, H, B) slabs, `rhos` the
    `rho_pack` penalties.  Rows t = 1..T; row 0 stays zero."""
    steps, _, hidden, batch = z.shape[-4:]
    cands = z.shape[0] if z.dim() == 5 else 1
    params = []
    for group in (gates, duals):
        ss = [_strides(t, 2) for t in group]
        params += [t.data_ptr() for t in group]
        params += [s for s, _ in ss] + [t for _, t in ss]
    zs, zt = _strides(z, 3)
    params += [z.data_ptr(), zs, zt, rhos.data_ptr(),
               7 if rhos.dim() == 2 else 0, out.data_ptr(), steps - 1,
               hidden, batch]
    blocks = max(1, min(65535, -(-hidden * batch // (RESMAX_THREADS * 16))))
    arr = (ctypes.c_longlong * len(params))(*params)
    launch(_LIB, 'stacked_resmax',
           [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.c_int], z.device, arr, len(params), cands, blocks,
           detail=f'z {tuple(z.shape)}')


def stacked_sweep(x_im: torch.Tensor, gates, duals, zs, zduals, layers,
                  m_invs: Sequence[torch.Tensor], rho, rho_z: torch.Tensor,
                  decay: float):
    """The stacked sweep's new slabs in one kernel launch (and one bounds
    pass per upper layer before it).

    Same arguments and return as `variants/stacked.py::
    stacked_sweep_plain`: x_im (T, I, B); per layer the previous epoch's
    GateSlabs and DualSlabs ([S,] T+1, H, B) and the upper layers' z and
    z-dual slabs ([S,] T+1, 4, H, B), each with its rows after the time
    axis contiguous; the epoch's new LSTMParams per layer and the M^-1 of
    each layer below the top ([S,] H, H); rho (Penalties) and rho_z, (S,)
    or 0-d; the dual decay.  Returns (gates, duals, zs, zduals): per layer
    the 6 new gate slabs i..h and the 5 dual slabs i..c, contiguous, and
    the upper layers' new z and z-dual slabs.  The top layer's h at T is
    zero (sweep.final writes it).  Adds one to `stacked_sweep.launches`.
    What the kernel does not take raises (ValueError, TypeError;
    RuntimeError from the launch)."""
    n = len(layers)
    hiddens = [lp.hidden_size for lp in layers]
    steps, inputs, batch = x_im.shape
    plan = stacked_sweep_plan(hiddens, inputs)
    if plan is None:
        raise ValueError(f'stacked_sweep: the stack {hiddens} on {inputs} '
                         f'inputs does not fit the kernel')
    lead = tuple(gates[0].i.shape[:-3])
    cands = lead[0] if lead else 1
    device = x_im.device
    _check_slab('x_im', x_im, tuple(x_im.shape), 3)
    if len(gates) != n or len(duals) != n or len(zs) != n - 1 or \
            len(zduals) != n - 1 or len(m_invs) != n - 1:
        raise ValueError('stacked_sweep: one GateSlabs, DualSlabs and '
                         'weight set a layer, z slabs and M^-1 a layer '
                         'above the first')
    for k, h in enumerate(hiddens):
        shape = lead + (steps + 1, h, batch)
        for f in 'ifgoch':
            _check_slab(f'gate {f} of layer {k}', getattr(gates[k], f),
                        shape, 2)
            _check_slab(f'dual {f} of layer {k}', getattr(duals[k], f),
                        shape, 2)
        if k:
            zshape = lead + (steps + 1, 4, h, batch)
            _check_slab(f'z of layer {k}', zs[k - 1], zshape, 3)
            _check_slab(f'z dual of layer {k}', zduals[k - 1], zshape, 3)

    rhos = rho_pack(rho, rho_z)
    weights = pack_weights(layers, m_invs, plan)
    resmax = torch.zeros((n - 1, cands, steps + 1), dtype=torch.int32,
                         device=device)
    for k in range(1, n):
        stacked_resmax(zs[k - 1], [gates[k][m] for m in range(4)],
                       [duals[k][m] for m in range(4)], rhos,
                       resmax[k - 1])

    empty = lambda shape: torch.empty(shape, dtype=torch.float32,
                                      device=device)
    new_gates = [[empty(lead + (steps + 1, h, batch)) for _ in range(6)]
                 for h in hiddens]
    new_duals = [[empty(lead + (steps + 1, h, batch)) for _ in range(5)]
                 for h in hiddens]
    new_zs = [empty(z.shape) for z in zs]
    new_zduals = [empty(z.shape) for z in zs]

    params = [n, steps, inputs, batch, plan.tb, plan.w_floats, plan.tgt,
              plan.rhs, x_im.data_ptr(), weights.data_ptr(),
              plan.w_floats if cands > 1 and weights.shape[0] > 1 else 0,
              rhos.data_ptr(), 7 if rhos.dim() == 2 else 0]
    for k in range(n):
        params += [hiddens[k], plan.rec[k], plan.inp[k], plan.minv[k],
                   plan.hbuf[k]]
        for group in (gates[k], duals[k]):
            slabs = [group[m] for m in range(6)]
            ss = [_strides(t, 2) for t in slabs]
            params += [t.data_ptr() for t in slabs]
            params += [s for s, _ in ss] + [t for _, t in ss]
        if k:
            for t in (zs[k - 1], zduals[k - 1]):
                params += [t.data_ptr(), *_strides(t, 3)]
            params += [t.data_ptr() for t in new_gates[k] + new_duals[k]]
            params += [new_zs[k - 1].data_ptr(),
                       new_zduals[k - 1].data_ptr(),
                       resmax[k - 1].data_ptr()]
        else:
            params += [0] * 6
            params += [t.data_ptr() for t in new_gates[k] + new_duals[k]]
            params += [0, 0, 0]
    arr = (ctypes.c_longlong * len(params))(*params)
    launch(_LIB, 'stacked_sweep',
           [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int], device,
           arr, len(params), float(decay), plan.rows, plan.threads,
           plan.smem, cands,
           detail=f'hiddens {hiddens}, S {cands}, T {steps}, B {batch}, '
                  f'plan {plan.tb}x{plan.rows}')
    stacked_sweep.launches += 1
    return new_gates, new_duals, new_zs, new_zduals


stacked_sweep.launches = 0
