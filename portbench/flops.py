"""The operations one ADMM epoch needs, from the configuration's shapes.

Counted are the multiply-adds (2 operations each) of the products and
contractions of one epoch of one instance, as the algorithm states them;
elementwise work is not counted.  Each weight block is updated once:
line-search retries are elementwise and recomputation is not counted.  A
symmetric Gram counts each of its D(D+1)/2 entries once.  The count does
not depend on the implementation that runs.  B train rows, Bv validation
rows, T steps, I inputs, H hidden units, O outputs; N = T B rows of the
weight stages, K = 4H gate columns.
"""

from __future__ import annotations


def _stage(n, k, d, exact):
    """One weight stage of width d: prox-linear (the gradient m^T r and its
    projection m grad) or exact (the symmetric Gram, its first-order term,
    G w, and one Cholesky solve per column)."""
    if not exact:
        return 2 * (2 * n * d * k)
    return (n * k * d * (d + 1) + 2 * n * d * k + 2 * k * d * d
            + k * (d ** 3 / 3 + 2 * d * d))


def epoch_ops(sizes: dict, exact_max_dim: int = 0) -> float:
    """Operations of one epoch at `sizes` (B, val, T, I, H, O); stages of
    width at most exact_max_dim take the exact solve."""
    b, bv, t = sizes['B'], sizes['val'], sizes['T']
    i, h, o = sizes['I'], sizes['H'], sizes['O']
    n, k = t * b, 4 * h
    exact = lambda d: bool(exact_max_dim) and d <= exact_max_dim
    ops = 2 * (2 * h * o * b)                 # wy: h_T wy and its gradient
    ops += 2 * n * i * k + 2 * n * h * k      # the stages' projections
    ops += _stage(n, k, i, exact(i))
    ops += 2 * n * i * k * exact(i)           # the fresh x-side projection
    ops += _stage(n, k, h, exact(h))
    ops += 2 * n * i * k + 2 * n * h * k      # the sweep's input and
                                              # recurrent products
    ops += 4 * (2 * h * o * b)                # final h: three products, h_T wy
    rows = (b + bv) * t                       # the losses' forward
    ops += 2 * rows * (i + h) * k + 2 * h * o * (b + bv)
    return float(ops)
