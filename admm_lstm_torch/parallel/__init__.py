"""Data-parallel consensus ADMM over `torch.distributed` (counterpart of
`admm_lstm_tpu/parallel`): the mesh of ranks, the block layout of the
batch and the sharded epoch functions.  The JAX package's
`batch_sharding` and `state_shardings` describe GSPMD placements and have
no counterpart here: the layout is `shard_range`'s contiguous blocks."""

from admm_lstm_torch.parallel.mesh import (Mesh, backend_for,
                                           initialize_multihost, make_mesh)
from admm_lstm_torch.parallel.sharding import (
    gather_state, make_sharded_epoch_fn, make_sharded_multi_epoch_best_fn,
    make_sharded_multi_epoch_fn, make_sharded_step, pad_batch, shard_batch,
    shard_range, shard_state)

__all__ = ['make_mesh', 'initialize_multihost', 'make_sharded_epoch_fn',
           'make_sharded_multi_epoch_fn', 'make_sharded_multi_epoch_best_fn',
           'make_sharded_step', 'shard_batch', 'shard_state', 'Mesh',
           'backend_for', 'gather_state', 'pad_batch', 'shard_range']
