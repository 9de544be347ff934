"""The data-parallel (consensus ADMM) layout and epoch functions.

Counterpart of `admm_lstm_tpu/parallel/sharding.py`, plain data
parallelism only.  The sample axis B of every per-sample tensor (the
inputs and targets, every gate and dual slab, the output auxiliary `a`
and its dual) is split into contiguous blocks, one per rank: rank r holds
samples [r*B/n, (r+1)*B/n), the block layout of the JAX package's
P(None, None, 'data').  The weights and scalar penalties are replicated.
Every sum over the batch in the epoch is all-reduced by the mesh's
`Consensus` (core/consensus.py), which is consensus ADMM on the shared
weights: each rank's trajectory is the single-process one up to the
order of the reductions.

The port holds each rank's block in its own contiguous tensors: a slice
of the batch-minor (T+1, H, B) slab would be a strided view, and the
sweep kernels and their 16-byte test (kernels/gate_sweep.py) take
contiguous slabs.  They run unchanged on the local block, because the
sweep is independent per batch column.

The time-sharded Jacobi layout and hidden-axis tensor parallelism of the
JAX package are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from admm_lstm_torch.api import batch_minor
from admm_lstm_torch.core.state import ADMMState, DualSlabs, GateSlabs
from admm_lstm_torch.core.step import (StepRules, admm_step, epoch_step,
                                       rules_for, run_epochs)
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


def _block(t, lo: int, hi: int, axis: int, device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t, np.float32))
    idx = (slice(None),) * axis + (slice(lo, hi),)
    return t[idx].to(device=device).contiguous()


def shard_batch(train_x, train_y, mesh: Mesh):
    """This rank's block of (B, T, I) inputs and (B, O) targets (numpy or
    tensors), as contiguous float32 tensors on the rank's device."""
    lo, hi = shard_range(train_x.shape[0], mesh.rank, mesh.world)
    return (_block(train_x, lo, hi, 0, mesh.device).float(),
            _block(train_y, lo, hi, 0, mesh.device).float())


def shard_state(state: ADMMState, mesh: Mesh) -> ADMMState:
    """This rank's block of a whole state: every slab and the (O, B)
    tensors `a`, y-dual cut on the batch axis into contiguous tensors on
    the rank's device; the weights, rho and beta replicated there."""
    lo, hi = shard_range(state.batch_size, mesh.rank, mesh.world)
    dev = mesh.device
    gates, duals = state.gates, state.duals
    return ADMMState(
        params=state.params.to(dev),
        gates=GateSlabs(*(_block(getattr(gates, k), lo, hi, 2, dev)
                          for k in _SLABS),
                        a=_block(gates.a, lo, hi, 1, dev)),
        duals=DualSlabs(*(_block(getattr(duals, k), lo, hi, 2, dev)
                          for k in _SLABS),
                        y=_block(duals.y, lo, hi, 1, dev)),
        rho=type(state.rho)(*(v.to(dev) for v in state.rho)),
        beta=type(state.beta)(*(v.to(dev) for v in state.beta)),
        epoch=state.epoch)


def _all_gather_host(t: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """Every rank's block of `t`, joined on `axis`, on the host.  The
    blocks travel as bytes over the gloo host group, whatever their
    dtype."""
    host = t.detach().to('cpu').contiguous()
    if mesh.world == 1:
        return host.clone()
    raw = host.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(mesh.world)]
    dist.all_gather(parts, raw, group=mesh.host_group)
    return torch.cat([p.view(t.dtype) for p in parts], dim=axis)


def gather_state(state: ADMMState, mesh: Mesh) -> ADMMState:
    """The whole state on the host, on every rank: the slabs gathered
    through host copies (two all-gathers), the replicated leaves this
    rank's."""
    gates, duals = state.gates, state.duals
    slabs = _all_gather_host(torch.stack(
        [getattr(gates, k) for k in _SLABS]
        + [getattr(duals, k) for k in _SLABS]), mesh, axis=3)
    outs = _all_gather_host(torch.stack([gates.a, duals.y]), mesh, axis=2)
    host = lambda group: type(group)(*(v.detach().cpu() for v in group))
    return ADMMState(
        params=host(state.params),
        gates=GateSlabs(*slabs[:6], a=outs[0]),
        duals=DualSlabs(*slabs[6:], y=outs[1]),
        rho=host(state.rho), beta=host(state.beta), epoch=state.epoch)


def sharded_rules(config: ADMMConfig, mesh: Mesh) -> StepRules:
    """The config's StepRules with the mesh's consensus: every batch sum
    of the epoch is all-reduced over the ranks.  The sweep kernels need
    nothing of the mesh (`use_pallas_sweep` resolves as in one
    process)."""
    return dataclasses.replace(rules_for(config), consensus=mesh.consensus)


def make_sharded_step(config: ADMMConfig, mesh: Mesh):
    """The epoch update on this rank's block: (state, x, y) -> state, with
    the state, (B/n, T, I) inputs and (B/n, O) targets local."""
    rules = sharded_rules(config, mesh)

    def step(state, x, y):
        return admm_step(state, x, y, rules)

    return step


def make_sharded_epoch_fn(config: ADMMConfig, mesh: Mesh):
    """One epoch and its losses: (state, x, y, vx, vy) -> (state,
    {'train_loss', 'val_loss'}), with x, y this rank's block and the
    validation arrays whole on every rank (their batch need not split)."""
    rules = sharded_rules(config, mesh)

    def epoch(state, x, y, vx, vy):
        x_im, y_im, xall_im, vy_im = batch_minor(x, y, vx, vy)
        return epoch_step(state, x_im, y_im, xall_im, vy_im, rules)

    return epoch


def make_sharded_multi_epoch_fn(config: ADMMConfig, mesh: Mesh,
                                num_epochs: int,
                                with_residuals: bool = False):
    """`num_epochs` epochs on this rank's block: (state, x, y, vx, vy) ->
    (state, metric trajectories with a leading (num_epochs,) axis), the
    residuals too under `with_residuals`."""
    rules = sharded_rules(config, mesh)

    def run(state, x, y, vx, vy):
        x_im, y_im, xall_im, vy_im = batch_minor(x, y, vx, vy)
        return run_epochs(state, num_epochs, x_im, y_im, xall_im, vy_im,
                          rules, with_residuals)

    return run


def make_sharded_multi_epoch_best_fn(config: ADMMConfig, mesh: Mesh,
                                     num_epochs: int,
                                     with_residuals: bool = False):
    """`make_sharded_multi_epoch_fn` with the best-validation carry:
    (state, best_val, best_params, x, y, vx, vy) -> (state, best_val,
    best_params, metrics).  The validation loss and the weights are
    replicated, so every rank carries the same best iterate."""
    rules = sharded_rules(config, mesh)

    def run(state, best_val, best_params, x, y, vx, vy):
        x_im, y_im, xall_im, vy_im = batch_minor(x, y, vx, vy)
        best: Dict[str, object] = {'val': best_val, 'params': best_params}
        state, metrics = run_epochs(state, num_epochs, x_im, y_im, xall_im,
                                    vy_im, rules, with_residuals, best)
        return state, best['val'], best['params'], metrics

    return run
