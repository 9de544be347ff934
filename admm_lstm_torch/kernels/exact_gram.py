"""The exact weight stage's Gram stack and first-order term: one
hand-written CUDA kernel for Hopper goes from the pre-activations to the
(S, K, D, D) Gram stack and the (S, K, D) first-order term in one pass,
and its plain PyTorch version.

`exact_gram` replaces no TPU kernel: the JAX package builds the Gram with
XLA's `dot_general`.  The plain version is the port's own route: the
activation lines of `solvers/normal_eq.gauss_newton_ridge_update_wide`
as full-slab passes, then `normal_eq._gram_bvec` (einsum, or the 'wide'
route's chunked weighted design and batched GEMM).  The kernel
(csrc/exact_gram.cu, which says what bounds it and how its design answers
that) keeps everything between its inputs and its outputs on chip, and
sums in FP32 FFMA.  Both return each instance's local sums; under data
parallelism the caller all-reduces them (core/consensus.py).

`exact_gram` launches the kernel for CUDA tensors and raises on what it
cannot take; it runs the plain version only for tensors that lie on the
CPU.  There is no fallback from the kernel to its plain version.
`use_gram_kernel` is the solver's dispatch; `gram_plan` picks the
kernel's tiles and parts from one instance's shape.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from admm_lstm_torch.kernels.build import launch

_LIB = 'exact_gram'

# The widest design a plan covers: every side of a stacked layer 0 up to
# 80 hidden units.  Wider stages keep the plain routes.
MAX_DIM = 80
# csrc/exact_gram.cu: rows n of a chunk, raw values a thread stages per
# input (two quads of rows x 4 b; design rows), threads a block.
CHUNK = 32
MAX_PF = 8
MAX_THREADS = 384
# Blocks an instance's launch aims for (k tiles x column tiles x parts).
_BLOCKS_PER_INSTANCE = 64


def activation_terms(pre: torch.Tensor, target_w: torch.Tensor,
                     tanh_cols: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s2, wres) = (act'^2, act' (act - target)) of the batch-minor slabs
    ([S,] T, K, B), linearizing each column's activation at `pre`.

    sigmoid(x) = (1 + tanh(x/2)) / 2: act = a + b*u, act' = c*(1 - u^2)
    with u = tanh(s*x) and per-column constants.  The constants are
    Python scalars: a tensor made on the host would be a copy that waits
    for the stream."""
    dtype = pre.dtype
    tanh_b = tanh_cols[:, None]                            # (K, 1)
    s_cols = torch.where(tanh_b, 1.0, 0.5).to(dtype)
    u = torch.tanh(s_cols * pre)
    act = torch.where(tanh_b, 0.0, 0.5).to(dtype) + s_cols * u
    d_act = torch.where(tanh_b, 1.0, 0.25).to(dtype) * (1.0 - u * u)
    return d_act * d_act, d_act * (act - target_w)


def exact_gram_plain(m_inputs: torch.Tensor, pre: torch.Tensor,
                     target_w: torch.Tensor, tanh_cols: torch.Tensor,
                     matmul_precision: str = 'highest',
                     strategy: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: `activation_terms`, then
    `normal_eq._gram_bvec` with `strategy` (None: picked by the shape).

    Args:
      m_inputs:  (T, D, B) design slab, shared, or (S, T, D, B).
      pre:       ([S,] T, K, B) pre-activations.
      target_w:  ([S,] T, K, B) the gate targets.
      tanh_cols: (K,) bool, the tanh gate's columns.
    Returns:
      gram ([S,] K, D, D) and bvec ([S,] K, D):
        gram[k] = sum_{t,b} act'^2 m m^T
        bvec[k] = sum_{t,b} act' (act - target) m
    """
    # The Gram routes live with the solver, which imports this module.
    from admm_lstm_torch.solvers.normal_eq import _gram_bvec
    s2, wres = activation_terms(pre, target_w, tanh_cols)
    return _gram_bvec(s2, wres, m_inputs, matmul_precision,
                      strategy=strategy)


def use_gram_kernel(device_type: str, matmul_precision: str,
                    dim: int) -> bool:
    """The exact stage takes the kernel for CUDA tensors at 'highest' and
    a design of at most MAX_DIM columns; the CPU, 'default' (the bf16
    operand rounding) and wider designs keep the plain routes."""
    return (device_type == 'cuda' and matmul_precision == 'highest'
            and 1 <= dim <= MAX_DIM)


class GramPlan(NamedTuple):
    """A block holds `rows` x 8 Gram rows (k) and `cols` x 8 columns of
    the packed symmetric half and bvec; `groups` splits each chunk of
    CHUNK b among its threads; an instance's chunks (T * ceil(B / CHUNK))
    fall into `parts` runs of `chunks_per_part`."""
    rows: int
    cols: int
    groups: int
    parts: int
    chunks_per_part: int

    @property
    def threads(self) -> int:
        return self.rows * self.cols * self.groups


def packed_columns(dim: int) -> int:
    """The kernel's columns: the D(D+1)/2 pairs and the D bvec columns,
    each padded to a multiple of 8."""
    pad8 = lambda x: -(-x // 8) * 8
    return pad8(dim * (dim + 1) // 2) + pad8(dim)


def gram_plan(n_cols: int, dim: int, steps: int, batch: int) -> GramPlan:
    """The plan for one instance's (T, K, B) slabs and (T, D, B) design.

    Column tiles of at most 36 groups of 8 (288 columns: the prologue's
    ~30 instructions an element against ~288 FMAs), row tiles of at most
    10 groups (80 rows), both split evenly.  The fewest power-of-two
    chunk groups that give every thread's 8 columns a 32-row chunk share
    (cols * groups >= 32), at least 8 row-groups of pair-product makers,
    and enough full warps to stage the tile (one per row group: two
    quads of rows each) and the design (MAX_PF rows each).  Parts: about
    _BLOCKS_PER_INSTANCE blocks an instance.  Nothing depends on S: an
    instance sums in the same order in any batch."""
    if min(n_cols, steps, batch) < 1 or not 1 <= dim <= MAX_DIM:
        raise ValueError(f'no exact Gram plan for K {n_cols}, D {dim}, '
                         f'T {steps}, B {batch}')
    col_groups = packed_columns(dim) // 8
    row_groups = -(-n_cols // 8)
    row_tiles = -(-row_groups // 10)
    rows = -(-row_groups // row_tiles)
    # Narrower column tiles where few rows leave too few threads to stage
    # a wide design.
    for col_tiles in range(-(-col_groups // 36), col_groups + 1):
        cols = -(-col_groups // col_tiles)
        groups = 1
        while (cols * groups < 32 or rows * groups < 8
               or rows * cols * groups // 32 < max(rows,
                                                   -(-dim // MAX_PF))):
            groups *= 2
        if groups <= CHUNK and rows * cols * groups <= MAX_THREADS:
            break
    else:
        raise ValueError(f'no exact Gram plan for K {n_cols}, D {dim}')
    col_tiles = -(-col_groups // cols)
    total = steps * -(-batch // CHUNK)
    parts = min(total, -(-_BLOCKS_PER_INSTANCE // (row_tiles * col_tiles)))
    per_part = -(-total // parts)
    return GramPlan(rows, cols, groups, -(-total // per_part), per_part)


def _check(m_inputs, pre, target_w, tanh_cols):
    if any(t.device != pre.device for t in (m_inputs, target_w, tanh_cols)):
        raise ValueError('exact_gram: all inputs must be on one device')
    if pre.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'exact_gram runs on CUDA or the CPU, not '
                         f'{pre.device}')
    if any(t.dtype != torch.float32 for t in (m_inputs, pre, target_w)):
        raise TypeError('exact_gram: the slabs must be float32')
    if tanh_cols.dtype != torch.bool:
        raise TypeError('exact_gram: tanh_cols must be bool')
    if pre.dim() not in (3, 4) or target_w.shape != pre.shape:
        raise ValueError(f'exact_gram: pre and target_w must be one '
                         f'([S,] T, K, B) shape, got {tuple(pre.shape)} '
                         f'and {tuple(target_w.shape)}')
    lead = pre.shape[:-3]
    steps, n_cols, batch = pre.shape[-3:]
    if (m_inputs.dim() not in (3, 3 + len(lead))
            or m_inputs.shape[:-3] not in ((), lead)
            or m_inputs.shape[-3] != steps or m_inputs.shape[-1] != batch):
        raise ValueError(f'exact_gram: m_inputs must be (T, D, B) or '
                         f'{lead + (steps, "D", batch)}, got '
                         f'{tuple(m_inputs.shape)}')
    if tuple(tanh_cols.shape) != (n_cols,):
        raise ValueError(f'exact_gram: tanh_cols must be ({n_cols},), got '
                         f'{tuple(tanh_cols.shape)}')


def _check_layout(m_inputs, pre, target_w, tanh_cols):
    """What the kernel takes beyond the plain version: b contiguous in
    every slab, a design of at most MAX_DIM columns, tanh_cols
    contiguous."""
    for name, t in (('m_inputs', m_inputs), ('pre', pre),
                    ('target_w', target_w)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f'exact_gram: {name} must have b contiguous; '
                             f'got strides {t.stride()}')
    if not 1 <= m_inputs.shape[-2] <= MAX_DIM:
        raise ValueError(f'exact_gram: the kernel takes designs of 1 to '
                         f'{MAX_DIM} columns, got {m_inputs.shape[-2]}')
    if not tanh_cols.is_contiguous():
        raise ValueError('exact_gram: tanh_cols must be contiguous')


def _strides(t: torch.Tensor, lead: bool) -> Tuple[int, int, int]:
    """(S, T, row) strides in floats; 0 for an absent S axis."""
    return ((t.stride(0) if lead and t.dim() == 4 else 0), t.stride(-3),
            t.stride(-2))


def exact_gram(m_inputs: torch.Tensor, pre: torch.Tensor,
               target_w: torch.Tensor, tanh_cols: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Gram stack and first-order term of the exact stage.

    Same arguments and return as `exact_gram_plain` at 'highest'.  CUDA
    tensors go to the CUDA kernel (which adds one to `exact_gram.launches`
    per launch) on `gram_plan`'s plan: every slab with b contiguous and
    any other strides (time-sliced views need no copy; a shared design
    has no S axis), D at most MAX_DIM.  T * B = 0 gives zeros, the sums
    of nothing, without a launch.  CPU tensors go to the plain version.
    What the kernel does not take raises (ValueError, TypeError;
    RuntimeError from the launch).
    """
    _check(m_inputs, pre, target_w, tanh_cols)
    if pre.device.type == 'cpu':
        return exact_gram_plain(m_inputs, pre, target_w, tanh_cols)
    _check_layout(m_inputs, pre, target_w, tanh_cols)
    lead = pre.shape[:-3]
    steps, n_cols, batch = pre.shape[-3:]
    dim = m_inputs.shape[-2]
    gram = torch.empty(lead + (n_cols, dim, dim), dtype=torch.float32,
                       device=pre.device)
    bvec = torch.empty(lead + (n_cols, dim), dtype=torch.float32,
                       device=pre.device)
    if steps * batch == 0 or n_cols == 0 or (lead and lead[0] == 0):
        return gram.zero_(), bvec.zero_()
    plan = gram_plan(n_cols, dim, steps, batch)
    n_inst = lead[0] if lead else 1
    part = torch.empty(n_inst * plan.parts * plan.groups * n_cols
                       * packed_columns(dim), dtype=torch.float32,
                       device=pre.device)
    strides = (_strides(pre, bool(lead)) + _strides(target_w, bool(lead))
               + _strides(m_inputs, bool(lead)))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch(_LIB, 'exact_gram', [vp] * 7 + [ci] * 5 + [cl] * 9 + [ci] * 5,
           pre.device, pre.data_ptr(), target_w.data_ptr(),
           m_inputs.data_ptr(), tanh_cols.data_ptr(), part.data_ptr(),
           gram.data_ptr(), bvec.data_ptr(), n_inst, n_cols, dim, steps,
           batch, *strides, *plan,
           detail=f'pre {tuple(pre.shape)}, m {tuple(m_inputs.shape)}, '
                  f'plan {tuple(plan)}')
    exact_gram.launches += 1
    return gram, bvec


exact_gram.launches = 0
