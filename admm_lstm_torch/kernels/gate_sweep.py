"""The fused interior timestep sweeps of the fast ADMM epoch: hand-written
CUDA kernels for Hopper and their plain PyTorch versions.

`interior_sweep` replaces
`admm_lstm_tpu/kernels/gate_sweep.py::pallas_interior_sweep`, with the
same argument and return contract, and takes an optional leading
candidate axis: S independent sweeps in one launch, as the JAX package's
`vmap` gives the Pallas kernel a leading grid axis (core/state.py says
what the axis is).  For t = 1..T-1, serially in time and
independently per batch column: the recurrent pre-activations
pre_g = xproj[t, g] + wh[g]^T h_{t-1}, the closed forms for i, f, g, o,
the c prox-linear step (theta = 1/2), the interior h, and the five dual
ascents i, f, g, o, c, with h_0 = c_0 = 0.

`jacobi_sweep` replaces `::pallas_jacobi_sweep`: the same per-timestep
math for every interior t at once, from the previous sweep's c[t-1] and a
pre-activation whose recurrent product the caller hoisted out, so every
element is independent.  It takes the same optional leading candidate
axis, all S sweeps in one launch.

`floor_sweep` replaces `benchmarks/bench_gs_floor.py::floor_sweep`, the
probe of the Gauss-Seidel sweep's serial floor: the bare LSTM recurrence
from the same projections and wh (`admm_lstm_torch/gs_floor.py` times
it).  `floor_plan` routes it by H: up to 32 hidden units to a kernel
written for the recurrence (a warp-synchronous step, the carry passed by
shuffles), above 32 to the same recurrence on `interior_sweep`'s tile
plan.

The wrappers launch their kernel (csrc/gate_sweep.cu) for CUDA tensors
and raise on anything they cannot take; they run the plain version only
for tensors that lie on the CPU.  There is no fallback from a kernel to
its plain version.  What bounds the kernels on an H100 (bytes: about
38 MB of slab traffic per sweep at GoogleStock) and how their design
answers that is written at the top of the CUDA source.  `sweep_plan`
picks the Gauss-Seidel kernel's tiles from the card's SM count and
shared-memory limit, `jacobi_plan` the Jacobi kernel's vector width and
grid from the SM count and the blocks an SM holds, `floor_plan` the floor
kernel and its grid; each kernel's entry point checks the plan it is
given.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from admm_lstm_torch.kernels.build import launch, load_library

Slabs = Tuple[torch.Tensor, ...]

_LIB = 'gate_sweep'

# Batch tiles, widest first: a warp spans 32 // tb row groups, and down to
# tb = 8 each of its row segments is a whole 32-byte sector.
SWEEP_TILES = (32, 16, 8, 4, 2, 1)
# Rows per thread -> threads per block the kernel is compiled for
# (csrc/gate_sweep.cu::sweep_max_threads): 14 prefetched inputs and 4
# accumulators per row stay in registers.
_MAX_THREADS = {1: 1024, 2: 512, 4: 512}
_WH_BUFS = 2               # the ring of streamed wh chunks (csrc WH_BUFS)
_CHUNKS = (8, 4, 2, 1)     # k-rows per streamed chunk, largest first


class SweepPlan(NamedTuple):
    """The Gauss-Seidel kernel's launch: `tb` batch columns per block,
    `rows` hidden rows (all four gates) of one column per thread,
    `threads` per block, wh rows padded to `hp` floats, `grid` blocks;
    k-rows 0 .. resident-1 of wh stay in shared memory and the rest (if
    resident < H) stream every step in chunks of `chunk` k-rows; wh goes
    to the kernel in its padded (H, hp, 4) layout (`padded_wh`) as well if
    `padded`; `smem` bytes of dynamic shared memory."""
    tb: int
    rows: int
    threads: int
    hp: int
    grid: int
    resident: int
    chunk: int
    padded: bool
    smem: int


def _fit(hidden: int, tb: int, hp: int, smem_limit: int):
    """(resident, chunk, smem) of wh for one tile, or None: all of wh in
    shared memory beside the double buffer of h if it fits, else a ring of
    two chunks (the largest of _CHUNKS that fits) and as many resident
    k-rows as the rest holds."""
    row_bytes = 16 * hp                               # a k-row, four gates
    h_bytes = 8 * hidden * tb
    if h_bytes + hidden * row_bytes <= smem_limit:
        return hidden, 0, h_bytes + hidden * row_bytes
    for chunk in _CHUNKS:
        ring = _WH_BUFS * chunk * row_bytes
        if h_bytes + ring <= smem_limit:
            resident = min(hidden - 1,
                           (smem_limit - h_bytes - ring) // row_bytes)
            return resident, chunk, h_bytes + ring + resident * row_bytes
    return None


def _tile_plan(hidden: int, batch: int, tb: int, rows: int,
              smem_limit: int, candidates: int = 1):
    """The plan of one tile width and rows per thread, or None if the
    kernel does not take it (too many threads, or h alone overfills shared
    memory).  Rows past H are padded with zeros to a multiple of R (hp).
    The grid covers `candidates` times the batch's tiles."""
    groups = -(-hidden // rows)
    if tb * groups > _MAX_THREADS[rows]:
        return None
    hp = groups * rows
    fit = _fit(hidden, tb, hp, smem_limit)
    if fit is None:
        return None
    resident, chunk, smem = fit
    return SweepPlan(tb, rows, tb * groups, hp, candidates * -(-batch // tb),
                     resident, chunk, rows > 1 or resident < hidden, smem)


def sweep_plan(hidden: int, batch: int, sms: int, smem_limit: int,
               candidates: int = 1) -> SweepPlan:
    """The tile plan of `interior_sweep` at hidden size H and batch B on a
    card with `sms` SMs and `smem_limit` bytes of shared memory per block,
    over `candidates` (S) sweeps at once: a block takes a tile of one
    candidate's batch, so the grid is S times the batch's tiles, and the
    plan is picked for S * B columns (S = 1: the sweep without the axis).

    Tiles: of those in SWEEP_TILES that give at least min(sms, S *
    ceil(B / 8)) blocks, the one with the fewest waves of one block per
    SM (a block that holds wh fills an SM's shared memory), then the one
    whose last wave fills the SMs best, the widest of equals.  Rows per
    thread: the fewest that fit the tile in the kernel's threads, at
    least 2 from H = 32, where the recurrent product's shared loads
    outweigh the math (at one row a thread, the math, a chain of
    transcendentals and IEEE divisions, is the step's latency).  wh is
    resident if it fits beside h, else partly streamed (`_fit`), and goes
    to the kernel padded where a thread takes more than one row or wh
    streams.  Steps do not enter the plan.  Raises ValueError for H
    beyond the kernel (above 2048)."""
    if hidden < 1 or batch < 1:
        raise ValueError(f'empty sweep: H {hidden}, B {batch}')
    if candidates < 1:
        raise ValueError(f'no candidates: {candidates}')
    least = 1 if hidden < 32 else 2
    target = min(sms, candidates * -(-batch // 8))
    best = None
    for tb in SWEEP_TILES:
        if candidates * -(-batch // tb) < target:
            continue
        plan = next((p for p in (_tile_plan(hidden, batch, tb, rows,
                                           smem_limit, candidates)
                                 for rows in _MAX_THREADS if rows >= least)
                     if p is not None), None)
        if plan is None:
            continue
        waves = -(-plan.grid // sms)
        key = (-waves, plan.grid / (waves * sms))
        if best is None or key > best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f'interior_sweep has no tile plan for H {hidden} '
                         f'(threads or {smem_limit} bytes of shared memory)')
    return best[1]


def padded_wh(wh: torch.Tensor, hp: int) -> torch.Tensor:
    """The kernel's layout of wh (4, H, H): (H, hp, 4), wh[g][k][j] at
    [k][j][g] and zero for j >= H, so a chunk of k-rows is one contiguous
    range and the four gates of one (k, j) are one 16-byte load; (S, H,
    hp, 4) for the candidate axis's (S, 4, H, H).  One copy kernel where
    hp = H (the zero fill only where there is padding)."""
    hidden = wh.shape[-1]
    out = (wh.new_zeros if hp > hidden else wh.new_empty)(
        wh.shape[:-3] + (hidden, hp, 4))
    out[..., :hidden, :].copy_(wh.movedim(-3, -1))
    return out


_LIMITS: Dict[int, Tuple[int, int]] = {}


def _card_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _card_limits(index: int) -> Tuple[int, int]:
    """(SM count, shared memory a block may opt in to) of card `index`,
    read from the CUDA runtime once per card."""
    if index not in _LIMITS:
        fn = load_library(_LIB).gate_sweep_limits
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        sms, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            err = fn(ctypes.byref(sms), ctypes.byref(smem))
        if err:
            raise RuntimeError(f'gate_sweep_limits: CUDA error {err}')
        _LIMITS[index] = (sms.value, smem.value)
    return _LIMITS[index]


def card_sweep_plan(device: torch.device, hidden: int, batch: int,
                    candidates: int = 1) -> SweepPlan:
    """`sweep_plan` with the SM count and shared-memory limit of `device`,
    read from the CUDA runtime once per card."""
    return sweep_plan(hidden, batch, *_card_limits(_card_index(device)),
                      candidates)


# The widest H of the floor's warp-synchronous kernel, its most warps a
# block and the steps of xproj it stages ahead (csrc/gate_sweep.cu
# FLOOR_MAX_WARPS, FLOOR_AHEAD).
FLOOR_WARP_MAX_H = 32
FLOOR_MAX_WARPS = 4
FLOOR_AHEAD = 4


class FloorPlan(NamedTuple):
    """`floor_sweep`'s launch.  Route 'warp' (H <= FLOOR_WARP_MAX_H): H
    lanes own a column, so a warp takes `cols` = 32 // H columns; the
    product runs over `lanes` k-rows (H rounded up to a power of two, the
    kernel instance); `warps` warps a block, `grid` blocks; `smem` bytes
    of shared memory, FLOOR_AHEAD + 1 slots of 4 xproj values a thread (wh
    stays in registers).  Route 'sweep' (wider H): `interior_sweep`'s tile
    plan `sweep`, whose grid and shared memory `grid` and `smem` repeat;
    `lanes`, `cols` and `warps` are 0."""
    route: str
    lanes: int
    cols: int
    warps: int
    grid: int
    smem: int
    sweep: Optional[SweepPlan] = None


def floor_plan(hidden: int, batch: int, sms: int,
               smem_limit: int) -> FloorPlan:
    """The plan of `floor_sweep` at hidden size H and batch B on a card
    with `sms` SMs and `smem_limit` bytes of shared memory per block.

    Up to FLOOR_WARP_MAX_H hidden units, the warp-synchronous kernel, 32 //
    H columns a warp: one warp a block while the warps, ceil(B / cols),
    are no more than the SMs, so that no two share an SM; else as many a
    block (up to FLOOR_MAX_WARPS, one on each of an SM's schedulers) as
    fill the SMs with one block each.  Above, the recurrence on
    `sweep_plan`'s tiles.  Steps do not enter the plan.  Raises ValueError for an empty sweep or
    H beyond `sweep_plan` (above 2048)."""
    if hidden < 1 or batch < 1 or sms < 1:
        raise ValueError(f'empty floor sweep or card: H {hidden}, B {batch}, '
                         f'{sms} SMs')
    if hidden > FLOOR_WARP_MAX_H:
        return floor_sweep_plan(sweep_plan(hidden, batch, sms, smem_limit))
    cols = 32 // hidden
    warps_total = -(-batch // cols)
    warps = min(FLOOR_MAX_WARPS, -(-warps_total // sms))
    smem = floor_smem(warps)
    if smem > smem_limit:
        raise ValueError(f'floor_sweep: the stage needs {smem} bytes of '
                         f'shared memory, the card has {smem_limit}')
    return FloorPlan('warp', 1 << (hidden - 1).bit_length(), cols, warps,
                     -(-warps_total // warps), smem)


def floor_smem(warps: int, ahead: int = FLOOR_AHEAD) -> int:
    """Shared-memory bytes of the warp-synchronous kernel at `warps` warps
    a block: `ahead` + 1 slots of 4 xproj values a thread."""
    return 16 * (ahead + 1) * 32 * warps


def card_floor_plan(device: torch.device, hidden: int,
                    batch: int) -> FloorPlan:
    """`floor_plan` with the SM count and shared-memory limit of `device`,
    read from the CUDA runtime once per card."""
    return floor_plan(hidden, batch, *_card_limits(_card_index(device)))


def floor_sweep_plan(plan: SweepPlan) -> FloorPlan:
    """The floor's 'sweep' route on `interior_sweep`'s tile plan `plan`,
    for any H (the route `floor_plan` takes above FLOOR_WARP_MAX_H)."""
    return FloorPlan('sweep', 0, 0, 0, plan.grid, plan.smem, plan)


# Threads per block of the Jacobi kernel (csrc/gate_sweep.cu JACOBI_THREADS).
JACOBI_THREADS = 128


class JacobiPlan(NamedTuple):
    """The Jacobi kernel's launch: `vec` floats per access (4: one float4
    per slab, or 1), `grid` blocks of `threads`, each thread taking at
    most `per_thread` items (an item: one step's `vec` consecutive floats
    of every slab), every (grid * threads)-th one."""
    vec: int
    per_thread: int
    threads: int
    grid: int


def jacobi_plan(steps: int, hidden: int, batch: int, sms: int,
                blocks_per_sm: Mapping[int, int],
                aligned: bool, candidates: int = 1) -> JacobiPlan:
    """The launch plan of `jacobi_sweep` at (steps, H, B) for `candidates`
    sweeps in one launch (the candidate axis; 1 without it) on a card with
    `sms` SMs, each holding `blocks_per_sm[v]` blocks of the kernel
    instance of vector width v (4 and 1) at once.

    V = 4 where every slab of a step starts on 16 bytes (H * B % 4 == 0
    and the tensors are `aligned`, candidate strides included) and the
    items of all candidates fill one whole wave of the card; else V = 1,
    whose four times as many threads each run a quarter of the math
    chain, which is faster where V = 4 leaves slots of the wave empty
    (`admm_lstm_torch/jacobi_ab.py` times both).  The grid is one whole
    wave, `sms * blocks_per_sm[V]` blocks, all resident together, where
    the items fill it, else one block per `threads` items.  Each thread
    takes every (grid * threads)-th item, so the threads' shares differ
    by at most one item.  Raises ValueError for an empty sweep or a card
    that holds no block."""
    if min(steps, hidden, batch, candidates) < 1:
        raise ValueError(f'empty sweep: steps {steps}, H {hidden}, B {batch},'
                         f' candidates {candidates}')
    if sms < 1 or min(blocks_per_sm[4], blocks_per_sm[1]) < 1:
        raise ValueError(f'no block fits: {sms} SMs, {dict(blocks_per_sm)} '
                         f'blocks an SM')
    slab = hidden * batch
    rows = candidates * steps
    wave4 = sms * blocks_per_sm[4] * JACOBI_THREADS
    vec = 4 if aligned and slab % 4 == 0 and rows * slab // 4 >= wave4 \
        else 1
    items = rows * slab // vec
    grid = min(-(-items // JACOBI_THREADS), sms * blocks_per_sm[vec])
    return JacobiPlan(vec, -(-items // (grid * JACOBI_THREADS)),
                      JACOBI_THREADS, grid)


_OCCUPANCY: Dict[Tuple[int, int], int] = {}


def jacobi_occupancy(device: torch.device, vec: int) -> Dict[str, int]:
    """Resident blocks per SM, registers and local (spill) bytes per
    thread of the Jacobi kernel instance `vec`, from the CUDA runtime."""
    fn = load_library(_LIB).gate_sweep_jacobi_occupancy
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    blocks, regs, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(_card_index(device)):
        err = fn(vec, ctypes.byref(blocks), ctypes.byref(regs),
                 ctypes.byref(local))
    if err:
        raise RuntimeError(f'gate_sweep_jacobi_occupancy: CUDA error {err}')
    return dict(blocks_per_sm=blocks.value, regs=regs.value,
                local_bytes=local.value)


def card_jacobi_plan(device: torch.device, steps: int, hidden: int,
                     batch: int, aligned: bool,
                     candidates: int = 1) -> JacobiPlan:
    """`jacobi_plan` with the SM count of `device` and the blocks per SM
    of both kernel instances, read from the CUDA runtime once per card."""
    index = _card_index(device)
    for vec in (4, 1):
        if (index, vec) not in _OCCUPANCY:
            _OCCUPANCY[index, vec] = jacobi_occupancy(
                device, vec)['blocks_per_sm']
    return jacobi_plan(steps, hidden, batch, _card_limits(index)[0],
                       {vec: _OCCUPANCY[index, vec] for vec in (4, 1)},
                       aligned, candidates)


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

    With the candidate axis every argument and result has a leading S
    axis (rho_vec (S, 6)), and each candidate's sweep runs on its own.
    """
    if xproj.dim() == 5:
        per = [interior_sweep_plain(xproj[s], wh[s], [g[s] for g in gates],
                                    [d[s] for d in duals], rho_vec[s])
               for s in range(xproj.shape[0])]
        return tuple(tuple(torch.stack(leaf) for leaf in zip(*part))
                     for part in zip(*per))
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

    With the candidate axis every argument and result has a leading S
    axis (rho_vec (S, 6)), and the pass broadcasts each candidate's rho
    over its (T-1, H, B).
    """
    del h_prev
    if pre.dim() == 5:
        rho_vec = rho_vec.T[:, :, None, None, None]   # (6, S, 1, 1, 1)
    out = _timestep_plain(pre.unbind(-3), gates, duals, c_prev, rho_vec)
    return tuple(out[:6]), tuple(out[6:])


def floor_sweep_plain(xproj: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `floor_sweep`: a loop over steps of
    the LSTM cell, h_0 = c_0 = 0.

    Args:
      xproj: (steps, 4, H, B) input projections, gates i, f, g, o.
      wh:    (4, H, H) recurrent weights, wh[g][k][j] from h[k] to row j.
    Returns:
      h, (steps, H, B).
    """
    steps, _, hidden, batch = xproj.shape
    h = xproj.new_zeros((hidden, batch))
    c = xproj.new_zeros((hidden, batch))
    out = []
    for t in range(steps):
        pre = xproj[t] + torch.einsum('hb,ghk->gkb', h, wh)
        c = (torch.sigmoid(pre[1]) * c
             + torch.sigmoid(pre[0]) * torch.tanh(pre[2]))
        h = torch.sigmoid(pre[3]) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


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


def _check_common(name, proj, gates, duals, rho_vec, lead=()):
    if len(gates) != 6 or len(duals) != 6:
        raise ValueError(f'need 6 gate and 6 dual slabs, got {len(gates)} '
                         f'and {len(duals)}')
    if proj.dim() != 4 + len(lead) or proj.shape[len(lead) + 1] != 4:
        raise ValueError(f'{name}: the projection must be (T-1, 4, H, B), '
                         f'got {tuple(proj.shape)}')
    if tuple(rho_vec.shape) != lead + (6,):
        raise ValueError(f'rho_vec must be {lead + (6,)}, got '
                         f'{tuple(rho_vec.shape)}')


def _check_axis(name, proj, others, slabs) -> Tuple[int, int, int]:
    """Checks a sweep's projection (T-1, 4, H, B), its other tensors
    `others` (shapes checked by the caller) and its slabs (T-1, H, B),
    each with or without a leading candidate axis; returns the candidates
    (1 without the axis) and the candidate strides in floats of the
    projection and of the slabs (0 without the axis).  With the axis the
    projection and each slab need only be contiguous within a candidate,
    the slabs with one candidate stride (slices of the state's
    (S, T+1, H, B) slabs and of the epoch's (S, T, 4, H, B) projection
    are)."""
    steps, _, hidden, batch = proj.shape[-4:]
    if proj.dim() == 4:
        _check_slabs(name, (proj, *others, *slabs), slabs, steps, hidden,
                     batch)
        return 1, 0, 0
    cands = proj.shape[0]
    _check_slabs(name, (proj[0], *others), (), steps, hidden, batch)
    for sl in slabs:
        if tuple(sl.shape) != (cands, steps, hidden, batch):
            raise ValueError(f'slabs must be {(cands, steps, hidden, batch)}'
                             f', got {tuple(sl.shape)}')
        if sl.device != proj.device or sl.dtype != torch.float32:
            raise ValueError(f'{name}: every slab must be float32 on '
                             f'{proj.device}')
    # One candidate has no stride to follow.
    stride = slabs[0].stride(0) if cands > 1 else 0
    if (any(not sl[0].is_contiguous() for sl in slabs)
            or any(sl.stride(0) != stride for sl in slabs if cands > 1)):
        raise ValueError(f'{name}: every slab must be contiguous within a '
                         f'candidate, with one candidate stride')
    return cands, proj.stride(0) if cands > 1 else 0, stride


def _check(xproj, wh, gates, duals, rho_vec) -> Tuple[int, int, int]:
    """Checks `interior_sweep`'s arguments; returns `_check_axis`'s
    candidates and strides."""
    lead = tuple(xproj.shape[:1]) if xproj.dim() == 5 else ()
    _check_common('interior_sweep', xproj, gates, duals, rho_vec, lead)
    hidden = xproj.shape[-2]
    if tuple(wh.shape) != lead + (4, hidden, hidden):
        raise ValueError(f'wh must be {lead + (4, hidden, hidden)}, '
                         f'got {tuple(wh.shape)}')
    return _check_axis('interior_sweep', xproj, (wh, rho_vec),
                       (*gates, *duals))


def _launch(symbol, first, operands, rho_vec, gates, duals, extra=(),
            wide=()):
    """Allocates the 11 outputs, shaped and placed as the slabs of `first`
    (with its leading candidate axis, if any), and launches `symbol` on
    the current stream of its card: `operands` are the leading tensors
    (None for a null pointer), then rho, the slabs and the outputs, steps,
    H, B, the ints `extra` and the 64-bit ints `wide`."""
    steps, _, hidden, batch = first.shape[-4:]
    outs = [torch.empty(first.shape[:-4] + (steps, hidden, batch),
                        dtype=torch.float32, device=first.device)
            for _ in range(11)]
    ins_arr = (ctypes.c_void_p * 12)(*(s.data_ptr() for s in (*gates, *duals)))
    outs_arr = (ctypes.c_void_p * 11)(*(o.data_ptr() for o in outs))
    vp = ctypes.c_void_p
    launch(_LIB, symbol,
           [vp] * (len(operands) + 1) + [ctypes.POINTER(vp)] * 2
           + [ctypes.c_int] * (3 + len(extra))
           + [ctypes.c_longlong] * len(wide),
           first.device,
           *(None if t is None else t.data_ptr() for t in operands),
           rho_vec.data_ptr(), ins_arr, outs_arr, steps, hidden, batch,
           *extra, *wide, detail=f'shape {tuple(first.shape)}'
                                 + (f', plan {extra}' if extra else ''))
    return tuple(outs[:6]), tuple(outs[6:])


def interior_sweep(xproj: torch.Tensor, wh: torch.Tensor,
                   gates: Sequence[torch.Tensor],
                   duals: Sequence[torch.Tensor],
                   rho_vec: torch.Tensor) -> Tuple[Slabs, Slabs]:
    """Interior timesteps t = 1..T-1 of the Gauss-Seidel sweep.

    Same arguments and returns as `interior_sweep_plain`, with or without
    the leading candidate axis: xproj (S, T-1, 4, H, B), wh (S, 4, H, H),
    rho_vec (S, 6), slabs (S, T-1, H, B), xproj and each slab contiguous
    within a candidate (a slice of the state's (S, T+1, H, B) slabs is),
    the slabs with one candidate stride, all S in one launch on
    `card_sweep_plan`'s plan for S * B columns.  CUDA
    tensors go to the CUDA kernel (which adds one to
    `interior_sweep.launches` per launch, with or without the axis, and
    one to `interior_sweep.candidate_launches` per launch with it); CPU
    tensors go to the plain version.
    """
    cands, xproj_stride, slab_stride = _check(xproj, wh, gates, duals,
                                              rho_vec)
    if xproj.device.type == 'cpu':
        return interior_sweep_plain(xproj, wh, gates, duals, rho_vec)
    _, _, hidden, batch = xproj.shape[-4:]
    plan = card_sweep_plan(xproj.device, hidden, batch, cands)
    whp = padded_wh(wh, plan.hp) if plan.padded else None
    out = _launch('gate_sweep_interior', xproj, (xproj, wh, whp), rho_vec,
                  gates, duals, (plan.tb, plan.rows, plan.hp, plan.resident,
                                 plan.chunk, plan.smem, cands),
                  (xproj_stride, slab_stride))
    interior_sweep.launches += 1
    if xproj.dim() == 5:
        interior_sweep.candidate_launches += 1
    return out


def floor_sweep(xproj: torch.Tensor, wh: torch.Tensor,
                plan: Optional[FloorPlan] = None) -> torch.Tensor:
    """The bare LSTM recurrence over every step.

    Same arguments and return as `floor_sweep_plain`.  CUDA tensors go to
    a CUDA kernel (which adds one to `floor_sweep.launches` per launch)
    with `plan`, by default `card_floor_plan`'s: up to 32 hidden units the
    warp-synchronous kernel, above them the recurrence on
    `interior_sweep`'s tile plan (`floor_sweep_plan` gives that route at
    any H).  A plan the kernel does not take raises RuntimeError.  CPU
    tensors go to the plain version.
    """
    if xproj.dim() != 4 or xproj.shape[1] != 4:
        raise ValueError(f'floor_sweep: the projection must be (steps, 4, H, '
                         f'B), got {tuple(xproj.shape)}')
    steps, _, hidden, batch = xproj.shape
    if tuple(wh.shape) != (4, hidden, hidden):
        raise ValueError(f'wh must be (4, {hidden}, {hidden}), '
                         f'got {tuple(wh.shape)}')
    _check_slabs('floor_sweep', (xproj, wh), (), steps, hidden, batch)
    if xproj.device.type == 'cpu':
        return floor_sweep_plain(xproj, wh)
    if plan is None:
        plan = card_floor_plan(xproj.device, hidden, batch)
    h = torch.empty((steps, hidden, batch), dtype=torch.float32,
                    device=xproj.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    detail = f'steps {steps}, H {hidden}, B {batch}, plan {plan}'
    if plan.route == 'warp':
        launch(_LIB, 'gate_sweep_floor_warp', [vp] * 3 + [ci] * 7,
               xproj.device, xproj.data_ptr(), wh.data_ptr(), h.data_ptr(),
               steps, hidden, batch, plan.lanes, plan.warps, plan.grid,
               plan.smem, detail=detail)
    else:
        sp = plan.sweep
        whp = padded_wh(wh, sp.hp) if sp.padded else None
        launch(_LIB, 'gate_sweep_floor', [vp] * 4 + [ci] * 9, xproj.device,
               xproj.data_ptr(), wh.data_ptr(),
               None if whp is None else whp.data_ptr(), h.data_ptr(), steps,
               hidden, batch, sp.tb, sp.rows, sp.hp, sp.resident, sp.chunk,
               sp.smem, detail=detail)
    floor_sweep.launches += 1
    return h


def _check_jacobi(pre, gates, duals, h_prev, c_prev,
                  rho_vec) -> Tuple[int, int, int]:
    """Checks `jacobi_sweep`'s arguments (h_prev and c_prev are slabs
    too); returns `_check_axis`'s candidates and strides."""
    lead = tuple(pre.shape[:1]) if pre.dim() == 5 else ()
    _check_common('jacobi_sweep', pre, gates, duals, rho_vec, lead)
    return _check_axis('jacobi_sweep', pre, (rho_vec,),
                       (h_prev, c_prev, *gates, *duals))


def tensor_jacobi_plan(pre: torch.Tensor, gates: Sequence[torch.Tensor],
                       duals: Sequence[torch.Tensor],
                       c_prev: torch.Tensor) -> JacobiPlan:
    """The plan `jacobi_sweep` takes by default for these CUDA tensors,
    with or without the candidate axis: float4 needs every slab of every
    candidate on 16 bytes, so the candidate strides count too."""
    steps, _, hidden, batch = pre.shape[-4:]
    cands = pre.shape[0] if pre.dim() == 5 else 1
    tensors = (pre, c_prev, *gates, *duals)
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if cands > 1:
        aligned = aligned and all(t.stride(0) % 4 == 0 for t in tensors)
    return card_jacobi_plan(pre.device, steps, hidden, batch, aligned, cands)


def jacobi_sweep(pre: torch.Tensor, gates: Sequence[torch.Tensor],
                 duals: Sequence[torch.Tensor], h_prev: torch.Tensor,
                 c_prev: torch.Tensor, rho_vec: torch.Tensor,
                 plan: Optional[JacobiPlan] = None) -> Tuple[Slabs, Slabs]:
    """Every interior timestep of the Jacobi sweep at once.

    Same arguments and returns as `jacobi_sweep_plain`, with or without
    the leading candidate axis: pre (S, T-1, 4, H, B), rho_vec (S, 6),
    slabs (S, T-1, H, B), pre and each slab contiguous within a candidate
    (a slice of the state's (S, T+1, H, B) slabs is), the slabs with one
    candidate stride, all S in one launch on `card_jacobi_plan`'s plan
    for S times the items.  CUDA tensors go to the CUDA kernel (which
    adds one to `jacobi_sweep.launches` per launch, with or without the
    axis, and one to `jacobi_sweep.candidate_launches` per launch with it)
    with `plan`, by default `tensor_jacobi_plan`'s: float4 accesses where
    every slab is 16-byte aligned and the items fill the card, else the
    same kernel one float at a time.  A plan the kernel does not take
    (float4 on a misaligned slab, a grid that does not cover the sweep)
    raises RuntimeError.  CPU tensors go to the plain version.
    """
    cands, pre_stride, slab_stride = _check_jacobi(pre, gates, duals, h_prev,
                                                   c_prev, rho_vec)
    if pre.device.type == 'cpu':
        return jacobi_sweep_plain(pre, gates, duals, h_prev, c_prev, rho_vec)
    if plan is None:
        plan = tensor_jacobi_plan(pre, gates, duals, c_prev)
    out = _launch('gate_sweep_jacobi', pre, (pre, c_prev), rho_vec, gates,
                  duals, tuple(plan) + (cands,), (pre_stride, slab_stride))
    jacobi_sweep.launches += 1
    if pre.dim() == 5:
        jacobi_sweep.candidate_launches += 1
    return out


interior_sweep.launches = 0
interior_sweep.candidate_launches = 0
jacobi_sweep.launches = 0
jacobi_sweep.candidate_launches = 0
floor_sweep.launches = 0
