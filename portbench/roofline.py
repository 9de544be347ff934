"""Peaks of one NVIDIA H100 SXM and the least time a kernel could take.

Published peaks (NVIDIA's data sheet, dense, at the 700 W power limit):
HBM3 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32, 989 TFLOP/s bf16.  A kernel's bound is the larger of the bytes its
call must move (each input byte read once, each output byte written once)
over the memory rate and the operations it must do over the float32 rate.
The byte and operation counts below are those of `chip_smoke.py`'s
`sweep_bound`, `jacobi_bound`, `solve_bound` and `inverse_bound`, with a
candidate axis (`cands` instances in one launch) where the kernel takes
one.
"""

from __future__ import annotations

PEAK_FLOPS = {'fp32': 67e12, 'tf32': 495e12, 'bf16': 989e12}
PEAK_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float):
    """(seconds, 'bytes' or 'operations'): the larger of the two times."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS['fp32']
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def sweep_bound(steps, hidden, batch, cands=1):
    """One Gauss-Seidel interior sweep per instance.  Bytes: 14 input slabs
    (4 xproj gates, old f, g, c, h, 6 duals), wh and rho once, 11 output
    slabs.  Operations: 8H per element and step for the recurrent dot
    products plus 105 for the closed forms, activations and duals."""
    elems = steps * hidden * batch
    return bound(4 * cands * (elems * (14 + 11) + 4 * hidden * hidden + 6),
                 cands * elems * (8 * hidden + 105))


def jacobi_bound(steps, hidden, batch, cands=1):
    """One Jacobi sweep per instance.  Bytes: 15 input slabs (4 pre gates,
    old f, g, c, h, 6 duals, c_prev), rho, 11 output slabs.  Operations:
    105 per element."""
    elems = steps * hidden * batch
    return bound(4 * cands * (elems * (15 + 11) + 6), cands * elems * 105)


def solve_bound(n, dim):
    """N SPD solves a x = b.  Bytes: the lower triangle of a, b and x once.
    Operations: D^3/3 for the factorization and D^2 per substitution."""
    return bound(4 * n * (dim * (dim + 1) // 2 + 2 * dim),
                 n * (dim ** 3 / 3 + 2 * dim * dim))


def inverse_bound(n, dim):
    """N factorizations with the inverse of L.  Bytes: the lower triangle
    of a once and all of L^-1 once.  Operations: c^3/3 for the
    factorization and c^3/3 for L X = I."""
    return bound(4 * n * (dim * (dim + 1) // 2 + dim * dim),
                 n * 2 * dim ** 3 / 3)
