"""Batched small Cholesky solves and triangular inverses: hand-written
CUDA kernels for Hopper and their plain PyTorch versions.

Replaces `admm_lstm_tpu/kernels/cholesky.py::pallas_chol_solve` (a x = b
for N SPD systems of width D <= 128) and `::pallas_chol_inverse` (L^-1 of
N SPD blocks, c <= 128, A = L L^T, exact zeros above the diagonal), with
the same argument and return contracts.  The exact weight solve
(solvers/normal_eq.py) calls `chol_solve` for its D <= 128 Gram systems,
and the blocked solve (solvers/blocked_chol.py) calls `chol_inverse` for
its diagonal blocks.

`chol_solve` and `chol_inverse` launch the kernels (csrc/cholesky.cu) for
CUDA tensors and raise on anything they cannot take; they run the plain
versions only for tensors that lie on the CPU.  There is no fallback from
a kernel to its plain version.  The plain versions are the unblocked
right-looking factorization over columns and right-looking substitutions,
every product and difference rounded on its own; the kernels (one warp
per system up to D = 32, blocked over 16-wide panels above) compute the
same quantities in another order with fused multiply-adds, so the two
agree to rounding, not bit for bit.  The kernels' designs and what bounds
them on an H100 are written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from admm_lstm_torch.kernels.build import launch

_LIB = 'cholesky'
MAX_DIM = 128


def _factor_plain(a: torch.Tensor) -> torch.Tensor:
    """L of a = L L^T, batched over the leading axis: unblocked
    right-looking Cholesky over columns, from the lower triangle of a."""
    dim = a.shape[-1]
    s = a.clone()
    low = torch.zeros_like(a)
    below = torch.arange(dim, device=a.device)
    for j in range(dim):
        inv = torch.sqrt(s[:, j, j]).reciprocal()
        lcol = torch.where(below >= j, s[:, :, j] * inv[:, None],
                           torch.zeros((), dtype=a.dtype, device=a.device))
        low[:, :, j] = lcol
        s = s - lcol[:, :, None] * lcol[:, None, :]
    return low


def chol_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `chol_solve`: a (N, D, D) SPD, b (N, D)
    -> x (N, D)."""
    low = _factor_plain(a)
    dim = a.shape[-1]
    resid, y = b.clone(), torch.zeros_like(b)
    for j in range(dim):                         # L y = b
        yj = resid[:, j] / low[:, j, j]
        y[:, j] = yj
        resid = resid - low[:, :, j] * yj[:, None]
    x = torch.zeros_like(b)
    for j in reversed(range(dim)):               # L^T x = y
        xj = y[:, j] / low[:, j, j]
        x[:, j] = xj
        y = y - low[:, j, :] * xj[:, None]
    return x


def chol_inverse_plain(a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `chol_inverse`: a (N, c, c) SPD ->
    L^-1 (N, c, c) with exact zeros above the diagonal."""
    low = _factor_plain(a)
    dim = a.shape[-1]
    resid = torch.eye(dim, dtype=a.dtype, device=a.device).expand_as(a)
    out = torch.zeros_like(a)
    for j in range(dim):                         # L X = I, row by row
        xj = resid[:, j, :] / low[:, j, j, None]
        out[:, j, :] = xj
        resid = resid - low[:, :, j, None] * xj[:, None, :]
    return out


def _check(name, a, b=None):
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f'{name}: a must be (N, D, D), got {tuple(a.shape)}')
    n, dim, _ = a.shape
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f'{name} handles 1 <= D <= {MAX_DIM}, got {dim}; '
                         f'wider systems go through solvers/blocked_chol')
    if n < 1:
        raise ValueError(f'{name}: no systems')
    tensors = (a,) if b is None else (a, b)
    if b is not None and tuple(b.shape) != (n, dim):
        raise ValueError(f'{name}: b must be ({n}, {dim}), '
                         f'got {tuple(b.shape)}')
    if any(t.device != a.device for t in tensors):
        raise ValueError(f'{name}: all inputs must be on one device')
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f'{name}: every input must be float32')
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f'{name}: every input must be contiguous')
    if a.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name} runs on CUDA or the CPU, not {a.device}')


def _launch(symbol, pointers, n, dim, device):
    vp = ctypes.c_void_p
    launch(_LIB, symbol, [vp] * len(pointers) + [ctypes.c_int, ctypes.c_int],
           device, *pointers, n, dim, detail=f'N {n}, D {dim}')


def chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve: a (N, D, D), b (N, D) -> x (N, D), D <= 128.

    CUDA tensors go to the CUDA kernel (which adds one to
    `chol_solve.launches` per launch); CPU tensors go to the plain
    version."""
    _check('chol_solve', a, b)
    if a.device.type == 'cpu':
        return chol_solve_plain(a, b)
    n, dim, _ = a.shape
    x = torch.empty_like(b)
    _launch('cholesky_solve', (a.data_ptr(), b.data_ptr(), x.data_ptr()),
            n, dim, a.device)
    chol_solve.launches += 1
    return x


def chol_inverse(a: torch.Tensor) -> torch.Tensor:
    """Batched triangular inverse of SPD blocks: a (N, c, c) -> L^-1
    (N, c, c) with a = L L^T, c <= 128, exact zeros above the diagonal.

    CUDA tensors go to the CUDA kernel (which adds one to
    `chol_inverse.launches` per launch); CPU tensors go to the plain
    version."""
    _check('chol_inverse', a)
    if a.device.type == 'cpu':
        return chol_inverse_plain(a)
    n, dim, _ = a.shape
    out = torch.empty_like(a)
    _launch('cholesky_inverse', (a.data_ptr(), out.data_ptr()), n, dim,
            a.device)
    chol_inverse.launches += 1
    return out


chol_solve.launches = 0
chol_inverse.launches = 0
