"""Blocked batched SPD solve for wide normal-equation systems (D > 128).

Counterpart of `admm_lstm_tpu/solvers/blocked_chol.py`: the LAPACK
blocked right-looking factorization, in which everything but the
`block`-wide diagonal blocks is a batched matrix product:

  for each panel j:
    Linv_jj   = L_jj^-1                   (kernels/cholesky.chol_inverse)
    L_ij      = A_ij @ Linv_jj^T          (panel: torch.matmul)
    A_trail  -= L_panel @ L_panel^T       (trailing update: torch.matmul)

Both substitutions then apply the Linv_jj blocks with products; no
triangular solve against the full D ever happens.  The trailing matrix
lives as column strips, as in the JAX package, so every slice is a
leading-rows slice of a strip.

The panel, trailing and substitution products follow the process-wide
matmul precision (api.train sets it from ADMMConfig.matmul_precision):
full FP32 at 'highest', TF32 at 'default'.  At 'default' an
ill-conditioned trailing block can go indefinite, and the diagonal's
square root then gives NaN; nothing here masks it.
"""

from __future__ import annotations

from typing import List

import torch

from admm_lstm_torch.kernels.cholesky import chol_inverse, chol_inverse_plain


def blocked_spd_solve(a: torch.Tensor, b: torch.Tensor, block: int = 64,
                      use_kernel: bool = True) -> torch.Tensor:
    """Solve K SPD systems a[k] x[k] = b[k]; a (K, D, D), b (K, D).

    use_kernel: the diagonal blocks go through `chol_inverse` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors); False
    runs `chol_inverse_plain` on any device.
    """
    k_sys, dim, _ = a.shape
    nb = -(-dim // block)
    dpad = nb * block - dim
    if dpad:
        # Identity-pad the diagonal so the padded systems stay SPD and the
        # padded solution coordinates are exactly zero.
        a = torch.nn.functional.pad(a, (0, dpad, 0, dpad))
        a[:, dim:, dim:] += torch.eye(dpad, dtype=a.dtype, device=a.device)
        b = torch.nn.functional.pad(b, (0, dpad))
    c = block
    inverse = chol_inverse if use_kernel else chol_inverse_plain

    # Column strips (K, D_pad - j*c, c) of the trailing matrix.
    strips = [a[:, :, j * c:(j + 1) * c] for j in range(nb)]
    l_blocks: List[List[torch.Tensor]] = [[None] * nb for _ in range(nb)]
    linv: List[torch.Tensor] = [None] * nb
    for j in range(nb):
        linv_j = inverse(strips[j][:, :c, :].contiguous())
        linv[j] = linv_j
        if j + 1 < nb:
            # Panel: L_ij = A_ij @ Linv_jj^T for all i > j at once.
            l_panel = torch.matmul(strips[j][:, c:, :], linv_j.transpose(1, 2))
            for i in range(j + 1, nb):
                l_blocks[i][j] = l_panel[:, (i - j - 1) * c:(i - j) * c]
            # Trailing update of each remaining strip i.
            for i in range(j + 1, nb):
                strips[i] = strips[i][:, c:, :] - torch.matmul(
                    l_panel, l_blocks[i][j].transpose(1, 2))

    bb = [b[:, j * c:(j + 1) * c] for j in range(nb)]

    def apply(m, v):                       # (K, r, s) x (K, s) -> (K, r)
        return torch.matmul(m, v[:, :, None])[:, :, 0]

    # Forward: L y = b, one product per block row for its inner sum.
    y = []
    for j in range(nb):
        r = bb[j]
        if j:
            row = torch.cat([l_blocks[j][k] for k in range(j)], dim=2)
            r = r - apply(row, torch.cat(y, dim=1))
        y.append(apply(linv[j], r))

    # Backward: L^T x = y; the column below diagonal j is panel j.
    x = [None] * nb
    for j in reversed(range(nb)):
        r = y[j]
        if j + 1 < nb:
            col = torch.cat([l_blocks[k][j] for k in range(j + 1, nb)], dim=1)
            r = r - apply(col.transpose(1, 2),
                          torch.cat([x[k] for k in range(j + 1, nb)], dim=1))
        x[j] = apply(linv[j].transpose(1, 2), r)

    out = torch.cat(x, dim=1)
    return out[:, :dim] if dpad else out
