"""Sharded consensus ADMM over `torch.distributed` (counterpart of
`admm_lstm_tpu/parallel`): the mesh of ranks with one process group per
axis, the three layouts of the state (data-parallel, time-sharded and
hidden-sharded, parallel/sharding.py) and the sharded epoch functions.
The JAX package's `batch_sharding` and `state_shardings` describe GSPMD
placements and have no counterpart here: a layout is the contiguous
blocks of `block_ranges`, which `shard_state` cuts and `gather_state`
joins."""

from admm_lstm_torch.parallel.mesh import (Mesh, backend_for,
                                           initialize_multihost, make_mesh)
from admm_lstm_torch.parallel.sharding import (
    block_ranges, gather_state, make_sharded_epoch_fn,
    make_sharded_multi_epoch_best_fn, make_sharded_multi_epoch_fn,
    make_sharded_step, pad_batch, shard_batch, shard_range, shard_state)

__all__ = ['make_mesh', 'initialize_multihost', 'make_sharded_epoch_fn',
           'make_sharded_multi_epoch_fn', 'make_sharded_multi_epoch_best_fn',
           'make_sharded_step', 'shard_batch', 'shard_state', 'Mesh',
           'backend_for', 'gather_state', 'pad_batch', 'shard_range',
           'block_ranges']
