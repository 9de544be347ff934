"""Process groups and the mesh of ranks of sharded training.

Counterpart of `admm_lstm_tpu/parallel/mesh.py`.  The JAX package is one
controller over a `jax.sharding.Mesh` of devices, and GSPMD inserts the
collectives.  The port keeps PyTorch's own idiom instead: one process per
rank (SPMD), an explicit `torch.distributed` process group and an
explicit device per rank.  `make_mesh` describes this rank's place in
the group.  A mesh has one or two axes, (data,) or (data, model), laid
out row-major over the ranks; each axis has its own `Consensus`
(core/consensus.py) over the ranks that differ only in that axis's
coordinate: `consensus` for the 'data' axis (the rows of the slabs:
blocks of the batch, or of the time rows) and `model` for the 'model'
axis (blocks of H).  A 2-D mesh builds one process group per row and per
column of the mesh (`dist.new_group`); an axis that spans every rank
uses the default group.

The backend is chosen by an explicit rule, never by a silent switch
(`backend_for`): NCCL for CUDA tensors, gloo for CPU tensors, or the
caller's choice.  NCCL refuses two ranks on one card ("Duplicate GPU
detected"), so ranks that share a card must ask for gloo, which
all-reduces CUDA tensors too.  PyTorch's backend table lists only
`broadcast` and `all_reduce` for gloo on CUDA tensors, so every gather
goes through host copies, over a gloo group (`Mesh.host_group`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from admm_lstm_torch.core.consensus import LOCAL, Consensus
from admm_lstm_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a sharded run: `coords` on the mesh of
    `shape`, the collectives of the 'data' axis (`consensus`) and of the
    'model' axis (`model`, the identity on a 1-D mesh).  `host_group`
    (None: the default group) runs the gathers of whole states through
    host copies and the barriers."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    world: int
    device: torch.device
    backend: Optional[str]
    host_group: object
    consensus: Consensus
    model: Consensus = LOCAL
    coords: Tuple[int, ...] = ()

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.host_group)

    def describe(self) -> dict:
        """The ranks, as the result of `api.train_sharded` reports them,
        with this rank's collectives so far: the all-reduces over every
        axis, and per axis each kind of collective."""
        axes = {'data': self.consensus, 'model': self.model}
        return {'shape': self.shape, 'axis_names': self.axis_names,
                'world': self.world, 'rank': self.rank,
                'coords': self.coords,
                'device': str(self.device), 'backend': self.backend,
                'all_reduces': sum(c.calls for c in axes.values()),
                'bytes_all_reduced': sum(c.nbytes for c in axes.values()),
                'collectives': {k: c.counts() for k, c in axes.items()}}


def shared_card_message(ranks: int, cards: int) -> str:
    return (f'{ranks} ranks on {cards} CUDA card(s) would share a card, and '
            f'NCCL refuses two ranks on one card ("Duplicate GPU '
            f'detected"); ask for backend="gloo" (the CLI does so by itself '
            f'and says so)')


def backend_for(device, ranks: int, backend: Optional[str] = None) -> str:
    """The backend of `ranks` processes on this host on `device`: 'gloo'
    on the CPU; on the card 'nccl' when every rank has a card of its own,
    and otherwise only what the caller asked for ('gloo'), since NCCL
    refuses ranks that share a card."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        if backend not in (None, 'gloo'):
            raise ValueError(f'backend {backend!r} does not take CPU '
                             f'tensors; the CPU runs on gloo')
        return 'gloo'
    cards = torch.cuda.device_count()
    if backend in (None, 'nccl') and ranks > cards:
        raise ValueError(shared_card_message(ranks, cards))
    return backend or 'nccl'


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device='cuda',
                         timeout: Optional[float] = None) -> None:
    """Joins this process to the process group of a data-parallel run
    (`torch.distributed.init_process_group`).

    Missing arguments come from torchrun's environment, as JAX discovers
    them on a pod: the coordinator from MASTER_ADDR/MASTER_PORT
    ('env://'), `num_processes` from WORLD_SIZE, `process_id` from RANK.
    `coordinator_address` is 'host:port' (TCP) or a URL such as
    'file:///path/store'.  `backend` None takes NCCL for `device`
    'cuda' (raising without a card) and gloo for 'cpu'.  `timeout`
    (seconds) bounds every collective and the rendezvous.
    """
    if backend is None:
        backend = 'nccl' if resolve_device(device).type == 'cuda' else 'gloo'
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f'tcp://{coordinator_address}'
    world = (int(os.environ['WORLD_SIZE']) if num_processes is None
             else int(num_processes))
    rank = int(os.environ['RANK']) if process_id is None else int(process_id)
    kw = {} if timeout is None else {'timeout': timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)


def _rank_device(device, rank: int) -> torch.device:
    """`device` for this rank: 'cuda' without an index is the card
    LOCAL_RANK (else the rank) modulo the cards of the host."""
    dev = resolve_device(device)
    if dev.type == 'cuda':
        if dev.index is None:
            local = int(os.environ.get('LOCAL_RANK', rank))
            dev = torch.device('cuda', local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ('data',),
              device='cuda') -> Mesh:
    """The mesh of every rank of the process group (one rank, with no
    collectives, outside a process group).

    shape=None puts every rank on one 'data' axis; (n_data, n_model) with
    axis_names ('data', 'model') is the 2-D mesh of tensor parallelism,
    rank r at coordinates (r // n_model, r % n_model).  A shape that needs
    more ranks than the group has raises ValueError, as the JAX package
    does for devices; so does one that leaves ranks of the group out
    (each rank is one process of the run), and one of more than two axes.
    Under NCCL, ranks of this host that would share a card raise
    ValueError naming gloo.
    """
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend())
    else:
        rank, world, backend = 0, 1, None
    if shape is None:
        shape, axis_names = (world,), tuple(axis_names)[:1]
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f'mesh shape {shape} with axis names {axis_names}')
    if len(shape) > 2:
        raise ValueError(f'mesh shape {shape}: a mesh has one axis (data) '
                         f'or two (data, model)')
    n = math.prod(shape)
    if n > world:
        raise ValueError(f'mesh shape {shape} needs {n} ranks, have {world}')
    if n < world:
        raise ValueError(f'mesh shape {shape} holds {n} ranks of the '
                         f'{world} in the process group; every rank of the '
                         f'group is one of the mesh')
    dev = _rank_device(device, rank)
    if backend == 'nccl':
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
        if local_world > torch.cuda.device_count():
            raise ValueError(shared_card_message(
                local_world, torch.cuda.device_count()))
    host_group = None
    if backend is not None and 'gloo' not in backend:
        host_group = dist.new_group(backend='gloo')
    n_model = shape[1] if len(shape) == 2 else 1
    d, m = rank // n_model, rank % n_model
    data, model = _axis_groups(shape[0], n_model, d, m)
    return Mesh(shape=shape, axis_names=axis_names, rank=rank, world=world,
                device=dev, backend=backend, host_group=host_group,
                consensus=data, model=model,
                coords=(d, m)[:len(shape)])


def _axis_groups(n_data: int, n_model: int, d: int,
                 m: int) -> Tuple[Consensus, Consensus]:
    """The 'data' and 'model' axes' Consensus of the rank at (d, m) of an
    (n_data, n_model) mesh.  Every rank creates every group, in the same
    order (`dist.new_group` is collective); an axis of one rank needs no
    group, and one that spans every rank takes the default group."""
    def axis(groups_of, n_axis, n_other, other, index):
        members = [groups_of(o) for o in range(n_other)]
        if n_axis == 1:
            return Consensus()
        groups = ([None] * n_other if n_other == 1
                  else [dist.new_group(ranks) for ranks in members])
        return Consensus(group=groups[other], world=n_axis, index=index,
                         ranks=members[other])

    data = axis(lambda mm: [dd * n_model + mm for dd in range(n_data)],
                n_data, n_model, m, d)
    model = axis(lambda dd: [dd * n_model + mm for mm in range(n_model)],
                 n_model, n_data, d, m)
    return data, model
