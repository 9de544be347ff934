"""Primal/dual residual monitoring and residual-balancing rho adaptation.

Counterpart of `admm_lstm_tpu/core/residuals.py`:
  * `admm_residuals_im(state, x_im)` - RMS primal violation per
    constraint family;
  * `dual_residuals(state, old_gates)` - rho * RMS change of each primal
    block between sweeps (Boyd et al. 2011, eq. 3.12);
  * `balanced_rho` - residual balancing (Boyd et al. 2011, section 3.4.1).
All results are 0-d tensors on the state's device (no host sync).

Under a mesh (core/consensus.py) each mean square is a global one: every
rank sums the squares of its block, the sums over H are all-reduced over
the 'model' ranks, every sum over the ranks that hold other rows (of the
batch, or of the time rows), and each is divided by the global count.
Time blocks are uneven (the ceil split), so a mean of the ranks' means
would weigh them wrongly.  `a` and the y-dual are replicated across the
time and 'model' ranks: under time sharding only the last time block
counts the y family.  Every rank sees the single-process residuals and
adapts rho the same way.

`rules` is anything with the StepRules fields `consensus`, `model` and
`shard_time` (None: one process).

With the candidate axis (core/state.py; one process only) every residual
is (S,), each candidate's RMS over its own slabs, and `balanced_rho`
adapts each candidate's rho on its own.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from admm_lstm_torch.core.consensus import LOCAL, time_block
from admm_lstm_torch.core.state import ADMMState, GateSlabs, Penalties

_FAMILIES = ('i', 'f', 'g', 'o', 'c', 'h', 'y')


def _axes(rules):
    if rules is None:
        return LOCAL, LOCAL, False
    return rules.consensus, rules.model, rules.shard_time


def _sum_square(x: torch.Tensor, dims) -> torch.Tensor:
    x = x.float()  # accumulate in f32 under bf16 slab storage
    return torch.sum(x * x) if dims is None else torch.sum(x * x, dim=dims)


def _rms(slabs: Dict[str, torch.Tensor], outs: Dict[str, torch.Tensor],
         slab_count: int, out_count: int, rules) -> Dict[str, torch.Tensor]:
    """{name: RMS over the whole state} of this rank's blocks of the slab
    families (over H and the rows) and the (O, B) families (over the rows
    only; None where another rank counts them), from one all-reduce per
    axis; (S,) each with the candidate axis."""
    rows, model, _ = _axes(rules)
    batched = next(iter(slabs.values())).dim() == 4
    slab_dims, out_dims = ((-3, -2, -1), (-2, -1)) if batched else (None,
                                                                    None)
    sums = model.all_sum(torch.stack([_sum_square(x, slab_dims)
                                      for x in slabs.values()]))
    zero = sums.new_zeros(sums.shape[1:])
    sums = torch.cat([sums, torch.stack([zero if x is None else
                                         _sum_square(x, out_dims)
                                         for x in outs.values()])])
    sums = rows.all_sum(sums).unbind()
    counts = [slab_count] * len(slabs) + [out_count] * len(outs)
    return {k: torch.sqrt(s / n)
            for k, s, n in zip(list(slabs) + list(outs), sums, counts)}


def _global_counts(state: ADMMState, rows: int, rules):
    """(elements of `rows` slab rows, of an (O, B) tensor) over every
    rank."""
    cons, model, shard_time = _axes(rules)
    batch = state.batch_size * (1 if shard_time else cons.world)
    hidden = state.hidden_size * model.world
    return rows * hidden * batch, state.gates.a.shape[-2] * batch


def _counts_y(rules) -> bool:
    """Whether this rank counts the replicated (O, B) family y: all but
    the earlier time blocks."""
    cons, _, shard_time = _axes(rules)
    return not shard_time or cons.index == cons.world - 1


def admm_residuals(state: ADMMState,
                   train_x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RMS primal residuals on (B, T, I) inputs."""
    return admm_residuals_im(state, train_x.permute(1, 2, 0))


def admm_residuals_im(state: ADMMState, x_im: torch.Tensor, rules=None
                      ) -> Dict[str, torch.Tensor]:
    """RMS primal residuals of each constraint family, on batch-minor
    (T, I, B) inputs.

      gate_g[t] = act(x_t Wx_g + h_{t-1} Wh_g)   for g in i,f,g,o
      c[t]      = f[t]*c[t-1] + i[t]*g[t]
      h[t]      = o[t]*tanh(c[t])
      a         = h_T @ wy

    On a time block the rows t >= 1 of the block are checked, with the
    previous block's last h and c (the halo) for t-1.
    """
    cons, model, shard_time = _axes(rules)
    g = state.gates
    p = state.params
    seq_len = x_im.shape[-3]
    lo, hi = 0, seq_len + 1
    h_prev, c_prev = g.h, g.c
    if shard_time:
        lo, hi = time_block(seq_len + 1, cons.index, cons.world)
        prev = cons.halo(torch.stack([g.h[-1], g.c[-1]]))
        if prev is not None:
            h_prev = torch.cat([prev[0:1], g.h])
            c_prev = torch.cat([prev[1:2], g.c])
    h_prev = model.all_gather(h_prev[..., :-1, :, :], -2)
    c_prev = c_prev[..., :-1, :, :]
    first = 1 if lo == 0 else 0
    now = lambda s: s[..., first:, :, :]
    x_rows = x_im[..., max(lo, 1) - 1:hi - 1, :, :]
    pre = (torch.einsum('...tdb,...gdh->...gthb', x_rows, p.wx)
           + torch.einsum('...tub,...guh->...gthb', h_prev.to(p.wh.dtype),
                          p.wh))
    pre = pre.unbind(-4)
    acts = (torch.sigmoid(pre[0]), torch.sigmoid(pre[1]),
            torch.tanh(pre[2]), torch.sigmoid(pre[3]))
    gates_now = (now(g.i), now(g.f), now(g.g), now(g.o))
    diffs = {f'r_{k}': gate - act
             for k, gate, act in zip(('i', 'f', 'g', 'o'), gates_now, acts)}
    diffs['r_c'] = now(g.c) - (now(g.f) * c_prev + now(g.i) * now(g.g))
    diffs['r_h'] = now(g.h) - now(g.o) * torch.tanh(now(g.c))
    outs = {'r_y': None}
    if _counts_y(rules):
        outs['r_y'] = g.a - model.all_sum(torch.einsum(
            '...hb,...ho->...ob', g.h[..., -1, :, :].to(p.wy.dtype), p.wy))
    slab_count, out_count = _global_counts(state, seq_len, rules)
    return _rms(diffs, outs, slab_count, out_count, rules)


def dual_residuals(state: ADMMState, prev_gates: GateSlabs, rules=None,
                   seq_len: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """RMS dual residuals: rho_k * ||primal_k^new - primal_k^old||_RMS.
    `seq_len`, the global T, is needed only under time sharding (a block
    does not know the other blocks' rows)."""
    g, r = state.gates, state.rho
    rows = state.seq_len + 1 if seq_len is None else seq_len + 1
    diffs = {k: getattr(g, k) - getattr(prev_gates, k)
             for k in ('i', 'f', 'g', 'o', 'c', 'h')}
    outs = {'y': g.a - prev_gates.a if _counts_y(rules) else None}
    slab_count, out_count = _global_counts(state, rows, rules)
    rms = _rms(diffs, outs, slab_count, out_count, rules)
    return {f's_{k}': getattr(r, k) * rms[k] for k in _FAMILIES}


def balanced_rho(rho: Penalties, primal: Dict[str, torch.Tensor],
                 dual: Dict[str, torch.Tensor], mu: float = 10.0,
                 tau: float = 2.0, rho_min: float = 1e-9,
                 rho_max: float = 1e3) -> Penalties:
    """Per family: rho *= tau when the primal residual exceeds mu x the
    dual residual, rho /= tau in the reverse case; clipped to
    [rho_min, rho_max]."""
    new = {}
    for k in _FAMILIES:
        v = getattr(rho, k)
        r, s = primal[f'r_{k}'], dual[f's_{k}']
        v_new = torch.where(r > mu * s, v * tau,
                            torch.where(s > mu * r, v / tau, v))
        new[k] = torch.clamp(v_new, rho_min, rho_max)
    return Penalties(**new)
