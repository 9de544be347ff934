"""The sharded layouts of the state and the sharded epoch functions.

Counterpart of `admm_lstm_tpu/parallel/sharding.py` (`state_shardings`,
:36-82), over a mesh of one axis, (data,), or two, (data, model)
(parallel/mesh.py).  Three layouts, as the JAX package's:

  * data parallelism (the default): the sample axis B of every per-sample
    tensor (the inputs and targets, every gate and dual slab, the output
    auxiliary `a` and its dual) is split into contiguous blocks over the
    'data' axis: rank d holds samples [d*B/n, (d+1)*B/n), the block layout
    of P(None, None, 'data').  The weights and scalar penalties are
    replicated.  Every sum over the batch in the epoch is all-reduced
    (core/consensus.py), which is consensus ADMM on the shared weights;
  * time-sharded (`shard_time=True`, sweep_mode='jacobi' only): each
    (T+1, H, B) slab is cut on its time axis into contiguous blocks over
    the 'data' axis, GSPMD's ceil split (`core/consensus.time_block`: the
    last block is shorter), the sequence-parallel layout for long T.  `a`,
    the y-dual, the weights, rho and beta are replicated, and the inputs
    are whole on every rank;
  * hidden-sharded (`model_axis='model'` on a 2-D mesh, tensor
    parallelism): each slab's H axis is cut into contiguous blocks over
    'model', and so are the output columns of wx and wh (4, D, H) and the
    rows of wy (H, O).  It composes with either layout above on the
    'data' axis.

Each rank's trajectory is the single-process one up to the order of the
reductions (core/step.py says which collective each phase needs).  The
layouts are reached as the JAX package reaches them, by an explicit
layout and no CLI flag: `shard_state(state, mesh, shard_time=...,
model_axis=...)` cuts a whole state into this rank's blocks, and the
`make_sharded_*` functions take the same two keywords.  `gather_state`
is its inverse, bit for bit.

The port holds each rank's block in its own contiguous tensors: a slice
of the batch-minor (T+1, H, B) slab would be a strided view, and the
sweep kernels and their 16-byte test (kernels/gate_sweep.py) take
contiguous slabs.  They run unchanged on the local block: the sweeps are
independent per batch column, and the Jacobi sweep per (t, h, b) too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from admm_lstm_torch.api import batch_minor
from admm_lstm_torch.core.consensus import LOCAL, Consensus, time_block
from admm_lstm_torch.core.state import ADMMState, DualSlabs, GateSlabs
from admm_lstm_torch.core.step import (StepRules, admm_step, epoch_step,
                                       rules_for, run_epochs)
from admm_lstm_torch.models.lstm import LSTMParams
from admm_lstm_torch.parallel.mesh import Mesh
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.logging import info

_SLABS = ('i', 'f', 'g', 'o', 'c', 'h')


def shard_range(batch: int, rank: int, world: int) -> Tuple[int, int]:
    """[lo, hi) of rank `rank`'s block of a batch of `batch` samples."""
    if batch % world:
        raise ValueError(f'batch {batch} does not split into {world} equal '
                         f'blocks; pad it first (pad_batch)')
    per = batch // world
    return rank * per, (rank + 1) * per


def pad_batch(train_x, train_y, world: int):
    """The batch padded to a multiple of `world` with duplicated tail
    samples, by the JAX package's index formula (api.py:715-721):
    [0, 1, ..., B-1] + [0, 1, ..., pad-1] mod B.  numpy arrays or
    tensors; unchanged when B divides."""
    batch = train_x.shape[0]
    if batch % world == 0:
        return train_x, train_y
    pad = world - batch % world
    info(f'Padding batch {batch} -> {batch + pad} to divide the '
         f'{world}-way data axis (duplicated tail samples).')
    idx = np.concatenate([np.arange(batch), np.arange(pad) % batch])
    if isinstance(train_x, torch.Tensor):
        idx = torch.from_numpy(idx).to(train_x.device)
    return train_x[idx], train_y[idx]


def _coords(mesh: Mesh, rank: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) coordinates of `rank` (default: this rank)."""
    if rank is None:
        if mesh.coords:
            return mesh.coords[0], (mesh.coords + (0,))[1]
        return mesh.consensus.index, 0
    n_model = mesh.shape[1] if len(mesh.shape) == 2 else 1
    return rank // n_model, rank % n_model


def _model_axis(mesh: Mesh, model_axis: Optional[str]) -> Consensus:
    """The collectives of `model_axis` (None: no hidden sharding)."""
    if model_axis is None:
        return LOCAL
    if len(mesh.axis_names) != 2 or mesh.axis_names[1] != model_axis:
        raise ValueError(f'model_axis {model_axis!r} is not the second axis '
                         f'of the mesh {mesh.axis_names} (a 2-D (data, '
                         f'model) mesh)')
    return mesh.model


def block_ranges(mesh: Mesh, coords: Tuple[int, int], rows: int,
                 hidden: int, batch: int, shard_time: bool = False,
                 model_axis: Optional[str] = None):
    """([t0, t1), [h0, h1), [b0, b1)) of the rank at `coords` in a state of
    `rows` (T+1) time rows, H = `hidden` and B = `batch` under the
    layout."""
    n_data = mesh.shape[0]
    n_model = mesh.shape[1] if len(mesh.shape) == 2 else 1
    d, m = coords
    if shard_time:
        if time_block(rows, n_data - 1, n_data)[0] >= rows:
            raise ValueError(f'{rows} time rows leave the last of {n_data} '
                             f'time blocks empty')
        t, b = time_block(rows, d, n_data), (0, batch)
    else:
        t, b = (0, rows), shard_range(batch, d, n_data)
    h = (0, hidden)
    if _model_axis(mesh, model_axis) is not LOCAL:
        if hidden % n_model:
            raise ValueError(f'H = {hidden} does not split into {n_model} '
                             f'equal blocks')
        per = hidden // n_model
        h = (m * per, (m + 1) * per)
    return t, h, b


def _to(t, device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t, np.float32))
    return t.to(device=device).contiguous()


def shard_batch(train_x, train_y, mesh: Mesh, shard_time: bool = False):
    """This rank's inputs (B, T, I) and targets (B, O) (numpy or tensors)
    as contiguous float32 tensors on the rank's device: its block of the
    batch on the 'data' axis, or the whole batch when the time rows are
    sharded."""
    lo, hi = 0, train_x.shape[0]
    if not shard_time:
        lo, hi = shard_range(hi, _coords(mesh)[0], mesh.shape[0])
    return (_to(train_x[lo:hi], mesh.device).float(),
            _to(train_y[lo:hi], mesh.device).float())


def _cut(state: ADMMState, t, h, b, device) -> ADMMState:
    """The block [t] x [h] x [b] of every slab, [b] of `a` and the y-dual,
    [h] of the weights' H; rho, beta and the epoch whole."""
    slab = lambda s: _to(s[t[0]:t[1], h[0]:h[1], b[0]:b[1]], device)
    out = lambda v: _to(v[:, b[0]:b[1]], device)
    gates, duals, p = state.gates, state.duals, state.params
    return ADMMState(
        params=LSTMParams(wx=_to(p.wx[..., h[0]:h[1]], device),
                          wh=_to(p.wh[..., h[0]:h[1]], device),
                          wy=_to(p.wy[h[0]:h[1]], device)),
        gates=GateSlabs(*(slab(getattr(gates, k)) for k in _SLABS),
                        a=out(gates.a)),
        duals=DualSlabs(*(slab(getattr(duals, k)) for k in _SLABS),
                        y=out(duals.y)),
        rho=type(state.rho)(*(v.to(device) for v in state.rho)),
        beta=type(state.beta)(*(v.to(device) for v in state.beta)),
        epoch=state.epoch)


def shard_state(state: ADMMState, mesh: Mesh, shard_time: bool = False,
                model_axis: Optional[str] = None) -> ADMMState:
    """This rank's block of a whole state under the layout (the module
    docstring), as contiguous tensors on the rank's device.  The
    carry-across path from JAX weights: `params_from_numpy`, then
    `init_admm_state` on the whole batch, then this."""
    t, h, b = block_ranges(mesh, _coords(mesh), state.seq_len + 1,
                           state.hidden_size, state.batch_size, shard_time,
                           model_axis)
    return _cut(state, t, h, b, mesh.device)


def _leaves(state: ADMMState):
    return ([getattr(state.gates, k) for k in _SLABS]
            + [getattr(state.duals, k) for k in _SLABS]
            + [state.gates.a, state.duals.y] + list(state.params))


def _all_gather_host(t: torch.Tensor, mesh: Mesh):
    """Every rank's `t` (equal shapes), on the host, in rank order."""
    host = t.detach().to('cpu').contiguous()
    if mesh.world == 1:
        return [host]
    parts = [torch.empty_like(host) for _ in range(mesh.world)]
    dist.all_gather(parts, host, group=mesh.host_group)
    return parts


def gather_state(state: ADMMState, mesh: Mesh, shard_time: bool = False,
                 model_axis: Optional[str] = None) -> ADMMState:
    """The whole state on the host, on every rank: the inverse of
    `shard_state` under the same layout, bit for bit.  Every rank's
    blocks travel as bytes over the host group (two all-gathers: the
    blocks' shapes, then their bytes, padded to the longest); replicated
    leaves are taken from the ranks that hold them, rho and beta from this
    one."""
    local = [t.detach().cpu().contiguous() for t in _leaves(state)]
    dims = [tuple(int(n) for n in d) for d in _all_gather_host(
        torch.tensor([state.gates.h.shape[0], state.hidden_size,
                      state.batch_size]), mesh)]
    coords = [_coords(mesh, k) for k in range(mesh.world)]
    # A dimension's whole size: the blocks along the axis that cuts it.
    total = lambda axis, along: sum(
        dims[k][axis] for k, c in enumerate(coords) if c[1 - along] == 0)
    tp = _model_axis(mesh, model_axis) is not LOCAL
    rows = total(0, 0) if shard_time else dims[0][0]
    hidden = total(1, 1) if tp else dims[0][1]
    batch = dims[0][2] if shard_time else total(2, 0)
    out_dim, in_dim = state.params.wy.shape[1], state.params.wx.shape[1]

    def shapes(r, h, b):
        return ([(r, h, b)] * 12 + [(out_dim, b)] * 2
                + [(4, in_dim, h), (4, hidden, h), (h, out_dim)])

    sizes = [[int(np.prod(shp)) * t.element_size()
              for shp, t in zip(shapes(*d), local)] for d in dims]
    raw = torch.cat([t.view(torch.uint8).reshape(-1) for t in local])
    raw = torch.cat([raw, raw.new_zeros(max(map(sum, sizes)) - raw.numel())])
    whole = [torch.empty(shp, dtype=t.dtype)
             for shp, t in zip(shapes(rows, hidden, batch), local)]
    for k, part in enumerate(_all_gather_host(raw, mesh)):
        (t0, t1), (h0, h1), (b0, b1) = block_ranges(
            mesh, coords[k], rows, hidden, batch, shard_time, model_axis)
        places = ([(slice(t0, t1), slice(h0, h1), slice(b0, b1))] * 12
                  + [(slice(None), slice(b0, b1))] * 2
                  + [(Ellipsis, slice(h0, h1))] * 2 + [(slice(h0, h1),)])
        at = 0
        for w, shp, n, where in zip(whole, shapes(*dims[k]), sizes[k],
                                    places):
            w[where] = part[at:at + n].clone().view(w.dtype).view(shp)
            at += n
    host = lambda group: type(group)(*(v.detach().cpu() for v in group))
    return ADMMState(
        params=LSTMParams(*whole[14:]),
        gates=GateSlabs(*whole[:6], a=whole[12]),
        duals=DualSlabs(*whole[6:12], y=whole[13]),
        rho=host(state.rho), beta=host(state.beta), epoch=state.epoch)


def sharded_rules(config: ADMMConfig, mesh: Mesh, shard_time: bool = False,
                  model_axis: Optional[str] = None) -> StepRules:
    """The config's StepRules on this rank's block: the 'data' axis's
    consensus all-reduces every sum over the rows (of the batch, or of the
    time rows under `shard_time`), and `model_axis` names the axis of the
    H blocks.  The sweep kernels need nothing of the mesh
    (`use_pallas_sweep` resolves as in one process)."""
    if shard_time and config.sweep_mode != 'jacobi':
        raise ValueError(f"shard_time takes sweep_mode='jacobi' (the "
                         f"Gauss-Seidel sweep is serial in time), not "
                         f"{config.sweep_mode!r}")
    return dataclasses.replace(rules_for(config), consensus=mesh.consensus,
                               model=_model_axis(mesh, model_axis),
                               shard_time=shard_time)


def make_sharded_step(config: ADMMConfig, mesh: Mesh, shard_time: bool = False,
                      model_axis: Optional[str] = None):
    """The epoch update on this rank's block: (state, x, y) -> state, with
    the state this rank's block (`shard_state` under the same layout) and
    the (B, T, I) inputs and (B, O) targets from `shard_batch`."""
    rules = sharded_rules(config, mesh, shard_time, model_axis)

    def step(state, x, y):
        return admm_step(state, x, y, rules)

    return step


def make_sharded_epoch_fn(config: ADMMConfig, mesh: Mesh,
                          shard_time: bool = False,
                          model_axis: Optional[str] = None):
    """One epoch and its losses: (state, x, y, vx, vy) -> (state,
    {'train_loss', 'val_loss'}), with x, y from `shard_batch` and the
    validation arrays whole on every rank (their batch need not split)."""
    rules = sharded_rules(config, mesh, shard_time, model_axis)

    def epoch(state, x, y, vx, vy):
        x_im, y_im, xall_im, vy_im = batch_minor(x, y, vx, vy)
        return epoch_step(state, x_im, y_im, xall_im, vy_im, rules)

    return epoch


def make_sharded_multi_epoch_fn(config: ADMMConfig, mesh: Mesh,
                                num_epochs: int,
                                with_residuals: bool = False,
                                shard_time: bool = False,
                                model_axis: Optional[str] = None):
    """`num_epochs` epochs on this rank's block: (state, x, y, vx, vy) ->
    (state, metric trajectories with a leading (num_epochs,) axis), the
    residuals too under `with_residuals`."""
    rules = sharded_rules(config, mesh, shard_time, model_axis)

    def run(state, x, y, vx, vy):
        x_im, y_im, xall_im, vy_im = batch_minor(x, y, vx, vy)
        return run_epochs(state, num_epochs, x_im, y_im, xall_im, vy_im,
                          rules, with_residuals)

    return run


def make_sharded_multi_epoch_best_fn(config: ADMMConfig, mesh: Mesh,
                                     num_epochs: int,
                                     with_residuals: bool = False,
                                     shard_time: bool = False,
                                     model_axis: Optional[str] = None):
    """`make_sharded_multi_epoch_fn` with the best-validation carry:
    (state, best_val, best_params, x, y, vx, vy) -> (state, best_val,
    best_params, metrics).  The validation loss is replicated, so every
    rank carries the same best iterate (its own block of the weights
    under tensor parallelism)."""
    rules = sharded_rules(config, mesh, shard_time, model_axis)

    def run(state, best_val, best_params, x, y, vx, vy):
        x_im, y_im, xall_im, vy_im = batch_minor(x, y, vx, vy)
        best: Dict[str, object] = {'val': best_val, 'params': best_params}
        state, metrics = run_epochs(state, num_epochs, x_im, y_im, xall_im,
                                    vy_im, rules, with_residuals, best)
        return state, best['val'], best['params'], metrics

    return run
