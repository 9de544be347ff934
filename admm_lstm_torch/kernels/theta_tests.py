"""The weight stage's theta tests: one hand-written CUDA kernel for Hopper
computes a block's whole table of candidate objective sums in one pass,
and its plain PyTorch version.

`theta_tests` replaces no TPU kernel: the JAX package runs the test
inside a `lax.while_loop` that XLA fuses.  In the port's
`solvers/prox_linear.weight_stage_update_wide` the test of a block of K
thetas was a Python loop of about 11 elementwise operations and two
reductions per theta over the whole ([S,] T, 4H, B) slabs; the kernel
(csrc/theta_tests.cu, which says what bounds it and how its design
answers that) reads `pre`, `grad_proj` and `target_w` once for all K
thetas and all S instances.  Both return each instance's local sums;
the caller all-reduces them (core/consensus.py).

`theta_tests` launches the kernel for CUDA tensors and raises on what it
cannot take; it runs the plain version only for tensors that lie on the
CPU.  There is no fallback from the kernel to its plain version.
`tests_plan` picks the kernel's vector width and grid.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from admm_lstm_torch.kernels.build import launch, load_library

_LIB = 'theta_tests'

# Threads per block and the most thetas a launch takes
# (csrc/theta_tests.cu THETA_THREADS, MAX_K).
THREADS = 256
MAX_K = 8


def theta_tests_plain(pre: torch.Tensor, grad_proj: torch.Tensor,
                      target_w: torch.Tensor, cands: torch.Tensor,
                      tanh_cols: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a loop over the K thetas.

    Args:
      pre:       ([S,] T, 4H, B) pre-activations at the current weights.
      grad_proj: ([S,] T, 4H, B) the gradient's projection.
      target_w:  ([S,] T, 4H, B) the gate targets.
      cands:     (K, [S,] 4) candidate thetas, one per gate.
      tanh_cols: (4H,) bool, the tanh gate's columns.
    Returns:
      (K, [S,] 4): per candidate and gate, the sum over (T, H, B) of
      (act(pre + grad_proj / theta) - target_w)^2, with sigmoid written
      0.5 + 0.5 * tanh(0.5 x).
    """
    dtype = pre.dtype
    hidden = pre.shape[-2] // 4
    tanh_b = tanh_cols[:, None]                            # (4H, 1) bool
    one, half = torch.tensor(1.0, dtype=dtype), torch.tensor(0.5, dtype=dtype)
    s_cols = torch.where(tanh_b, one, half).to(pre.device)
    a_cols = torch.where(tanh_b, torch.tensor(0.0, dtype=dtype),
                         half).to(pre.device)
    sums = []
    for th in cands:
        th_cols = torch.repeat_interleave(th, hidden, dim=-1)
        th_cols = th_cols[..., None].unsqueeze(-3)         # ([S,] 1, 4H, 1)
        r = (a_cols + s_cols * torch.tanh(s_cols * (pre + grad_proj / th_cols))
             - target_w)
        sq = torch.sum(r * r, dim=(-3, -1))
        sums.append(sq.reshape(sq.shape[:-1] + (4, hidden)).sum(-1))
    return torch.stack(sums)


class TestsPlan(NamedTuple):
    """The kernel's launch: `vec` floats per access (4 or 1) and `grid`
    blocks of THREADS."""
    vec: int
    grid: int


def tests_plan(cands: int, steps: int, hidden: int, batch: int,
               aligned: bool, sms: int,
               blocks_per_sm: Mapping[int, int]) -> TestsPlan:
    """The launch plan at `cands` instances (S; 1 without the candidate
    axis) of (steps, 4 * hidden, batch) slabs on a card with `sms` SMs,
    each holding `blocks_per_sm[v]` blocks of the kernel instance of
    vector width v (4 and 1).  float4 where the slabs are `aligned`
    (16-byte pointers, S and T strides of multiples of 4 floats) and
    H * B % 4 == 0, else one float.  The grid is one wave of resident
    blocks, fewer where there are fewer than THREADS units a block, and at
    least one block per (instance, gate) group, which keeps every block's
    range of units within two groups."""
    if min(cands, steps, hidden, batch) < 1:
        raise ValueError(f'empty theta tests: S {cands}, T {steps}, '
                         f'H {hidden}, B {batch}')
    vec = 4 if aligned and hidden * batch % 4 == 0 else 1
    if sms < 1 or blocks_per_sm[vec] < 1:
        raise ValueError(f'no block fits: {sms} SMs, {blocks_per_sm[vec]} '
                         f'blocks an SM')
    units = 4 * cands * steps * hidden * batch // vec
    grid = max(min(sms * blocks_per_sm[vec], -(-units // THREADS)),
               4 * cands)
    return TestsPlan(vec, grid)


_OCCUPANCY: Dict[Tuple[int, int], Dict[str, int]] = {}


def occupancy(device: torch.device, vec: int) -> Dict[str, int]:
    """SM count, resident blocks per SM, registers and local (spill) bytes
    per thread of the kernel instance `vec` on `device`, from the CUDA
    runtime once per card."""
    index = _card_index(device)
    if (index, vec) not in _OCCUPANCY:
        fn = load_library(_LIB).theta_tests_occupancy
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        fn.restype = ctypes.c_int
        vals = [ctypes.c_int() for _ in range(4)]
        with torch.cuda.device(index):
            err = fn(vec, *(ctypes.byref(v) for v in vals))
        if err:
            raise RuntimeError(f'theta_tests_occupancy: CUDA error {err}')
        _OCCUPANCY[index, vec] = dict(zip(
            ('sms', 'blocks_per_sm', 'regs', 'local_bytes'),
            (v.value for v in vals)))
    return _OCCUPANCY[index, vec]


def _card_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _lead_strides(t: torch.Tensor) -> Tuple[int, int]:
    """A slab's S and T strides in floats, 0 where the axis is absent or
    has one entry (the kernel never steps along it)."""
    s = t.stride(0) if t.dim() == 4 and t.shape[0] > 1 else 0
    return s, (t.stride(-3) if t.shape[-3] > 1 else 0)


def card_tests_plan(pre: torch.Tensor, grad_proj: torch.Tensor,
                    target_w: torch.Tensor) -> TestsPlan:
    """`tests_plan` for these CUDA slabs on their card."""
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st % 4 == 0 for st in _lead_strides(t))
                  for t in (pre, grad_proj, target_w))
    steps, cols, batch = pre.shape[-3:]
    occ = {vec: occupancy(pre.device, vec) for vec in (4, 1)}
    return tests_plan(pre.shape[0] if pre.dim() == 4 else 1, steps,
                      cols // 4, batch, aligned, occ[4]['sms'],
                      {vec: o['blocks_per_sm'] for vec, o in occ.items()})


def _check(pre, grad_proj, target_w, cands, tanh_cols):
    slabs = (pre, grad_proj, target_w)
    tensors = slabs + (cands, tanh_cols)
    if any(t.device != pre.device for t in tensors):
        raise ValueError('theta_tests: all inputs must be on one device')
    if pre.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'theta_tests runs on CUDA or the CPU, not '
                         f'{pre.device}')
    if any(t.dtype != torch.float32 for t in slabs + (cands,)):
        raise TypeError('theta_tests: the slabs and thetas must be float32')
    if tanh_cols.dtype != torch.bool:
        raise TypeError('theta_tests: tanh_cols must be bool')
    if pre.dim() not in (3, 4) or pre.shape[-2] % 4:
        raise ValueError(f'theta_tests: slabs must be ([S,] T, 4H, B), got '
                         f'{tuple(pre.shape)}')
    if any(t.shape != pre.shape for t in slabs):
        raise ValueError(f'theta_tests: pre, grad_proj and target_w must '
                         f'share one shape, got '
                         f'{[tuple(t.shape) for t in slabs]}')
    lead = pre.shape[:-3]
    if (cands.dim() != 2 + len(lead) or tuple(cands.shape[1:]) != lead + (4,)
            or not 1 <= cands.shape[0] <= MAX_K):
        raise ValueError(f'theta_tests: thetas must be (K, {lead + (4,)}) '
                         f'with 1 <= K <= {MAX_K}, got {tuple(cands.shape)}')
    if tuple(tanh_cols.shape) != (pre.shape[-2],):
        raise ValueError(f'theta_tests: tanh_cols must be '
                         f'({pre.shape[-2]},), got {tuple(tanh_cols.shape)}')


def _check_layout(pre, grad_proj, target_w, tanh_cols):
    """What the kernel takes beyond the plain version: each slab
    contiguous in (4H, B), B innermost, and tanh_cols contiguous."""
    batch = pre.shape[-1]
    for name, t in zip(('pre', 'grad_proj', 'target_w'),
                       (pre, grad_proj, target_w)):
        if t.stride(-2) != batch or (t.stride(-1) != 1 and batch > 1):
            raise ValueError(f'theta_tests: {name} must be contiguous in '
                             f'(4H, B), B innermost; got strides '
                             f'{t.stride()}')
    if not tanh_cols.is_contiguous():
        raise ValueError('theta_tests: tanh_cols must be contiguous')


def theta_tests(pre: torch.Tensor, grad_proj: torch.Tensor,
                target_w: torch.Tensor, cands: torch.Tensor,
                tanh_cols: torch.Tensor) -> torch.Tensor:
    """The (K, [S,] 4) table of one block's candidate sums.

    Same arguments and return as `theta_tests_plain`, K at most MAX_K.
    CUDA tensors go to the CUDA kernel (which adds one to
    `theta_tests.launches` per launch) on `card_tests_plan`'s plan: the
    slabs each with (4H, B) contiguous, B innermost, and any S and T
    strides, the thetas any view; its activation is each gate's, read at
    the gate's first column of `tanh_cols`.  Empty slabs give a table of
    zeros, the sums of nothing, without a launch.  CPU tensors go to the
    plain version.  What the kernel does not take raises (ValueError,
    TypeError; RuntimeError from the launch).
    """
    _check(pre, grad_proj, target_w, cands, tanh_cols)
    if pre.device.type == 'cpu':
        return theta_tests_plain(pre, grad_proj, target_w, cands, tanh_cols)
    _check_layout(pre, grad_proj, target_w, tanh_cols)
    if pre.numel() == 0:
        return torch.zeros(cands.shape, dtype=torch.float32,
                           device=pre.device)
    plan = card_tests_plan(pre, grad_proj, target_w)
    steps, cols, batch = pre.shape[-3:]
    lead = pre.shape[:-3]
    n_cands = lead[0] if lead else 1
    out = torch.empty(cands.shape, dtype=torch.float32, device=pre.device)
    part = torch.empty(plan.grid * 2 * MAX_K, dtype=torch.float32,
                       device=pre.device)
    ticket = _ticket(pre.device)
    strides = [st for t in (pre, grad_proj, target_w)
               for st in _lead_strides(t)]
    th = cands.stride()
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch(_LIB, 'theta_tests', [vp] * 8 + [ci] * 7 + [cl] * 9, pre.device,
           pre.data_ptr(), grad_proj.data_ptr(), target_w.data_ptr(),
           cands.data_ptr(), tanh_cols.data_ptr(), out.data_ptr(),
           part.data_ptr(), ticket.data_ptr(), cands.shape[0], n_cands,
           steps, cols // 4, batch, plan.vec, plan.grid, *strides,
           th[0], th[1] if lead else 0, th[-1],
           detail=f'shape {tuple(pre.shape)}, K {cands.shape[0]}, '
                  f'plan {tuple(plan)}')
    theta_tests.launches += 1
    return out


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The kernel's last-block ticket for the current stream of `device`:
    one zeroed int32 that every launch leaves at zero, so launches on one
    stream share it and launches on two streams never do."""
    index = _card_index(device)
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


theta_tests.launches = 0
