"""Exact ridge / Gauss-Newton weight solves (the turbo/auto weight stage).

Counterpart of `admm_lstm_tpu/solvers/normal_eq.py`.  Instead of the
reference's single linearized prox step per epoch (admm.py:340-343), the
weight stage solves the linearized subproblem exactly: per output column,
a (D x D) ridge-regularized normal-equation system, all 4H columns of a
stage as one batch of SPD systems.  D <= 128 goes to the batched Cholesky
kernel (kernels/cholesky.chol_solve), wider systems to the blocked solve
(solvers/blocked_chol.py), whose diagonal blocks use
kernels/cholesky.chol_inverse.

The Gram builders and their strategy thresholds are the JAX package's,
kept for parity: the thresholds are TPU measurements and have not been
decided again on the H100.  `matmul_precision` mirrors the JAX
`precision` argument: at 'default' the JAX package rounds the operands of
the wide, blocktri and pair Grams to bf16 and accumulates in f32
(`preferred_element_type`).  Here the operands are rounded to bf16 and
back, and the product runs in f32: products of bf16 values are exact in
f32 and in TF32, so the result matches the JAX package on the CPU and on
the card.  Every other product follows the process-wide matmul precision.

Under data parallelism (core/consensus.py) each rank builds the Gram stack
and the first-order term from its block of the batch, and both are
all-reduced in one packed call before the trace, the Levenberg-Marquardt
anchor and the right-hand side; every rank then solves the same
replicated systems.  The same holds for blocks of the time rows.  Under
tensor parallelism each rank builds and solves the systems of its own
columns only (the columns are independent), on its own stack.  The Gram
strategy is picked from the global shape, 4H columns and T * B rows, as
the JAX package sees it, so that every rank takes the path (and, at
'default', the bf16 roundings) a single process takes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from admm_lstm_torch.core.consensus import LOCAL, Consensus
from admm_lstm_torch.kernels.cholesky import (MAX_DIM, chol_solve,
                                              chol_solve_plain)
from admm_lstm_torch.solvers.blocked_chol import blocked_spd_solve

# The fused three-operand einsum while its (4H, D, T*B)-sized
# intermediate stays below this many elements; the chunked wide
# contraction above it (JAX normal_eq.py:35-40).
_EINSUM_MAX_ELEMS = 1 << 25
_CHUNK_BUDGET_ELEMS = 1 << 26
_BLOCKTRI_BLK = 128
GRAM_STRATEGIES = ('einsum', 'wide', 'blocktri', 'pair')


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and back to f32."""
    return x.to(torch.bfloat16).float()


def _gram_strategy(n_cols: int, dim: int, n_rows: int) -> str:
    """The JAX package's Gram dispatch for (K=n_cols, D=dim, N=n_rows)."""
    if n_cols * dim * n_rows <= _EINSUM_MAX_ELEMS:
        return 'einsum'
    return 'blocktri' if dim > _BLOCKTRI_BLK else 'wide'


def _rows_times(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., k, r, N) x (s, N) -> (..., k, r, s) as one 2-D product
    a_flat @ m^T of the row-major a, with no batched route between; with
    a per-candidate m (S, s, N), one product per candidate."""
    k, r, n = a.shape[-3:]
    if m.dim() == 2:
        return (a.reshape(-1, n) @ m.T).reshape(a.shape[:-1] + (m.shape[0],))
    return (a.reshape(a.shape[:-3] + (k * r, n)) @ m.mT).reshape(
        a.shape[:-1] + (m.shape[-2],))


def _divisor_chunk(n_cols: int, budget: int) -> int:
    chunk = max(1, min(n_cols, budget))
    while n_cols % chunk:
        chunk -= 1
    return chunk


def _gram_bvec(s2: torch.Tensor, wres: torch.Tensor, m_inputs: torch.Tensor,
               matmul_precision: str = 'highest',
               strategy: Optional[str] = None, world: int = 1):
    """Gram stack (K, D, D) and first-order term (K, D) from batch-minor
    slabs s2/wres (T, K, B) and design slab m_inputs (T, D, B):

      gram[k] = sum_{t,b} s2[t,k,b] * m[t,:,b] m[t,:,b]^T
      bvec[k] = sum_{t,b} wres[t,k,b] * m[t,:,b]

    With the candidate axis s2 and wres are (S, T, K, B) and the results
    (S, K, D, D), (S, K, D); m_inputs is shared (T, D, B) or per
    candidate (S, T, D, B).  `strategy` forces one of GRAM_STRATEGIES;
    None picks by one candidate's shape, with the rows of all `world`
    ranks' equal blocks of the batch.
    """
    lead = s2.shape[:-3]
    steps, n_cols, batch = s2.shape[-3:]
    dim = m_inputs.shape[-2]
    n_rows = steps * batch
    strategy = strategy or _gram_strategy(n_cols, dim, n_rows * world)
    if strategy not in GRAM_STRATEGIES:
        raise ValueError(f'unknown Gram strategy {strategy!r}')
    if n_rows == 0:         # a time block with no target rows
        return (s2.new_zeros(lead + (n_cols, dim, dim)),
                s2.new_zeros(lead + (n_cols, dim)))
    if strategy == 'einsum':
        gram = torch.einsum('...tkb,...tdb,...teb->...kde', s2, m_inputs,
                            m_inputs)
        bvec = torch.einsum('...tkb,...tdb->...kd', wres, m_inputs)
        return gram, bvec

    # (D, N) / (K, N) row-flattened, row-major.  The slabs may arrive in
    # another memory order (torch.einsum returns the projections as
    # permuted views), and a column-major (K, N) would make every product
    # below copy its (chunk, D, N) operand.
    m2, s2f, wresf = (v.transpose(-3, -2).reshape(v.shape[:-3]
                                                  + (-1, n_rows)).contiguous()
                      for v in (m_inputs, s2, wres))
    bvec = wresf @ m2.mT

    bf16 = matmul_precision == 'default'
    round_ = _bf16 if bf16 else (lambda x: x)
    m2c, s2c = round_(m2), round_(s2f)

    if strategy == 'pair':
        return _gram_pair(s2c, m2c, dim, n_cols, n_rows, round_), bvec

    if strategy == 'blocktri':
        bounds = list(range(0, dim, _BLOCKTRI_BLK)) + [dim]
        chunk = _divisor_chunk(n_cols,
                               _CHUNK_BUDGET_ELEMS // (_BLOCKTRI_BLK * n_rows))
        grams = []
        for s2_c in s2c.split(chunk, dim=-2):
            blocks = {}
            for bi in range(len(bounds) - 1):
                i0, i1 = bounds[bi], bounds[bi + 1]
                a_i = round_(s2_c[..., :, None, :]
                             * m2c[..., None, i0:i1, :])
                for bj in range(bi + 1):
                    j0, j1 = bounds[bj], bounds[bj + 1]
                    blocks[(bi, bj)] = _rows_times(a_i, m2c[..., j0:j1, :])
            rows = []
            for bi in range(len(bounds) - 1):
                rows.append(torch.cat(
                    [blocks[(bi, bj)] if bj <= bi
                     else blocks[(bj, bi)].transpose(-2, -1)
                     for bj in range(len(bounds) - 1)], dim=-1))
            grams.append(torch.cat(rows, dim=-2))
        return torch.cat(grams, dim=-3), bvec

    # wide: K/chunk batched (D, N) x (N, D) products.
    chunk = _divisor_chunk(n_cols, _CHUNK_BUDGET_ELEMS // (dim * n_rows))
    grams = [_rows_times(round_(s2_c[..., :, None, :] * m2c[..., None, :, :]),
                         m2c)
             for s2_c in s2c.split(chunk, dim=-2)]
    return torch.cat(grams, dim=-3), bvec


def _gram_pair(s2c, m2c, dim, n_cols, n_rows, round_):
    """Gram stack via the symmetric pair-product contraction
    (JAX normal_eq.py:188-225): P[(d,e), n] = m[d, n] * m[e, n] for the
    D(D+1)/2 pairs d <= e, packed = s2 @ P^T in pair-chunks, then the
    symmetric unpack."""
    iu, ju = np.triu_indices(dim)
    n_pairs = iu.shape[0]
    chunk = max(1, min(n_pairs, _CHUNK_BUDGET_ELEMS // n_rows))
    iu_t = torch.from_numpy(iu).to(m2c.device)
    ju_t = torch.from_numpy(ju).to(m2c.device)
    packed = torch.cat([
        s2c @ round_(m2c[..., iu_t[p:p + chunk], :]
                     * m2c[..., ju_t[p:p + chunk], :]).mT
        for p in range(0, n_pairs, chunk)], dim=-1)         # (K, pairs)
    pair_of = np.zeros((dim, dim), np.int64)
    pair_of[iu, ju] = np.arange(n_pairs)
    pair_of[ju, iu] = np.arange(n_pairs)
    return packed[..., torch.from_numpy(pair_of).to(m2c.device)]


def _spd_solve(lhs: torch.Tensor, rhs: torch.Tensor,
               use_pallas_chol) -> torch.Tensor:
    """The exact stage's batched SPD solve of (..., D, D) systems: every
    leading axis (the candidates', the 4H columns') folds into one batch,
    so a stage is one call.  True and 'auto' take the kernels (for CUDA
    tensors; the wrappers run the plain versions on CPU tensors); False
    runs the plain versions."""
    use_kernel = use_pallas_chol in (True, 'auto')
    dim = lhs.shape[-1]
    lhs = lhs.reshape(-1, dim, dim).contiguous()
    rhs_flat = rhs.reshape(-1, dim).contiguous()
    if dim <= MAX_DIM:
        out = (chol_solve if use_kernel else chol_solve_plain)(lhs, rhs_flat)
    else:
        out = blocked_spd_solve(lhs, rhs_flat, use_kernel=use_kernel)
    return out.reshape(rhs.shape)


def gauss_newton_ridge_update_wide(m_inputs: torch.Tensor, pre: torch.Tensor,
                                   weights_w: torch.Tensor,
                                   target_w: torch.Tensor,
                                   rho_g: torch.Tensor, beta_g: torch.Tensor,
                                   tanh_cols: torch.Tensor,
                                   matmul_precision: str = 'highest',
                                   damping: float = 1e-6, prox: float = 0.25,
                                   use_pallas_chol: object = 'auto',
                                   consensus: Consensus = LOCAL,
                                   total_rows: Optional[int] = None,
                                   total_cols: Optional[int] = None
                                   ) -> torch.Tensor:
    """The exact weight stage in the gate-folded, batch-minor layout.

    Shapes: m_inputs (T, D, B); pre = m_inputs @ weights_w + the frozen
    side's projection, and target_w, (T, 4H, B); weights_w (D, 4H) with
    gate-major columns; rho_g and beta_g (4,).  Returns the new (D, 4H)
    weights.  With the candidate axis pre, target_w, weights_w, rho_g and
    beta_g carry a leading S, m_inputs is shared or has one too, and the
    S x 4H systems go to one batched solve.

    Linearizing act at pre, per column k with r = act - target and
    s = act':
        G_k    = sum_{t,b} s^2 m m^T
        rhs_k  = rho (G_k w_k - sum_{t,b} s r m) + mu w_k
        w_k^+  = solve((beta + mu) I + rho G_k, rhs_k)
    with the Levenberg-Marquardt anchor mu = prox * rho * mean(diag G_k)
    + damping (JAX normal_eq.py:350-357 says why).

    `total_rows` (T * B) and `total_cols` (4H) are the global shape the
    Gram strategy is picked from (default: this rank's rows times the
    consensus world, and its columns).
    """
    dtype, device = weights_w.dtype, weights_w.device
    hidden = weights_w.shape[-1] // 4
    rho_cols = torch.repeat_interleave(rho_g, hidden, dim=-1)    # ([S,] 4H)
    beta_cols = torch.repeat_interleave(beta_g, hidden, dim=-1)
    dim = m_inputs.shape[-2]
    tanh_b = tanh_cols[:, None]                            # (4H, 1)

    # sigmoid(x) = (1 + tanh(x/2)) / 2: act = a + b*u, act' = c*(1 - u^2)
    # with u = tanh(s*x) and per-column constants.  The constants are
    # Python scalars: a tensor made on the host would be a copy that
    # waits for the stream.
    s_cols = torch.where(tanh_b, 1.0, 0.5).to(dtype)
    u = torch.tanh(s_cols * pre)
    act = torch.where(tanh_b, 0.0, 0.5).to(dtype) + s_cols * u
    d_act = torch.where(tanh_b, 1.0, 0.25).to(dtype) * (1.0 - u * u)

    resid = act - target_w
    s2 = d_act * d_act
    steps, n_cols, batch = pre.shape[-3:]
    strategy = _gram_strategy(
        n_cols if total_cols is None else total_cols, dim,
        steps * batch * consensus.world if total_rows is None
        else total_rows)
    gram, bvec = consensus.all_sum_packed(*_gram_bvec(
        s2, d_act * resid, m_inputs, matmul_precision, strategy=strategy))
    eye = torch.eye(dim, dtype=dtype, device=device)

    trace = torch.einsum('...kdd->...k', gram) / dim       # ([S,] 4H)
    mu = prox * rho_cols * trace + damping
    lhs = (beta_cols[..., None, None] * eye
           + rho_cols[..., None, None] * gram + mu[..., None, None] * eye)
    w_cols = weights_w.mT                                  # ([S,] 4H, D)
    rhs = (rho_cols[..., None] * (torch.einsum('...kde,...ke->...kd', gram,
                                               w_cols) - bvec)
           + mu[..., None] * w_cols)
    return _spd_solve(lhs, rhs, use_pallas_chol).mT


def gauss_newton_ridge_update(m_inputs: torch.Tensor,
                              fixed_proj: torch.Tensor,
                              weights: torch.Tensor,
                              gate_target: torch.Tensor,
                              rho_g: torch.Tensor, beta_g: torch.Tensor,
                              is_tanh: torch.Tensor,
                              damping: float = 1e-6, prox: float = 0.25,
                              use_pallas_chol: object = 'auto'
                              ) -> torch.Tensor:
    """The same exact solve in the stacked layout (JAX normal_eq.py:
    307-387): m_inputs (T, B, D); fixed_proj, gate_target (4, T, B, H);
    weights (4, D, H).  Returns (4, D, H)."""
    tanh_b = is_tanh[:, None, None, None]
    pre = torch.einsum('tbd,gdh->gtbh', m_inputs, weights) + fixed_proj
    sig = torch.sigmoid(pre)
    th = torch.tanh(pre)
    act = torch.where(tanh_b, th, sig)
    d_act = torch.where(tanh_b, 1.0 - th ** 2, sig * (1.0 - sig))

    resid = act - gate_target
    s2 = d_act * d_act
    gram = torch.einsum('gtbh,tbd,tbe->ghde', s2, m_inputs, m_inputs)
    bvec = torch.einsum('gtbh,tbd->ghd', d_act * resid, m_inputs)

    dim = m_inputs.shape[-1]
    eye = torch.eye(dim, dtype=weights.dtype, device=weights.device)
    rho_b = rho_g[:, None, None, None]
    trace = torch.einsum('ghdd->gh', gram) / dim           # (4, H)
    mu = prox * rho_b[..., 0, 0] * trace + damping
    lhs = (beta_g[:, None, None, None] * eye + rho_b * gram
           + mu[..., None, None] * eye)
    w_cols = weights.transpose(1, 2)                       # (4, H, D)
    rhs = (rho_b[..., 0] * (torch.einsum('ghde,ghe->ghd', gram, w_cols)
                            - bvec)
           + mu[..., None] * w_cols)
    return _spd_solve(lhs, rhs, use_pallas_chol).transpose(1, 2)
