"""Starting the ranks of a data-parallel run on one host.

`spawn` starts one process per rank (torch.multiprocessing, 'spawn'),
joins them into a process group through a FileStore in a directory of
its own (no TCP port to collide on) and returns what each rank's
function returned.  A rank's function must be importable by the new
process: a module-level function, such as `run_cases`, which runs
several calls in one process group: of `api.train_sharded` (which runs
it so when it is called outside a process group), or of `run_layout`
for the explicit layouts.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _to_cpu(obj):
    """`obj` with every tensor in it (in tuples, lists and dicts) on the
    CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               timeout: Optional[float], threads: Optional[int],
               fn: Callable, args: Sequence, run_dir: str) -> None:
    from admm_lstm_torch.parallel.mesh import initialize_multihost
    from admm_lstm_torch.utils.logging import set_console_enabled
    try:
        if threads:
            torch.set_num_threads(threads)
        if rank:
            set_console_enabled(False)      # rank 0 speaks for the run
        initialize_multihost(init_method, world, rank, backend=backend,
                             timeout=timeout)
        try:
            out = _to_cpu(fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
        path = os.path.join(run_dir, f'rank{rank}.pt')
        torch.save(out, path + '.tmp')
        os.replace(path + '.tmp', path)
    except BaseException:
        with open(os.path.join(run_dir, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, args: Sequence = (), *,
          backend: str = 'gloo', timeout: Optional[float] = None,
          threads: Optional[int] = None,
          workdir: Optional[str] = None) -> List[object]:
    """fn(rank, world, *args) in `world` new processes joined by a process
    group of `backend`; returns each rank's result, moved to the CPU, in
    rank order.

    timeout: seconds that bound every collective and the whole run; past
    it the ranks are killed and TimeoutError is raised (None: no bound on
    the run, PyTorch's default on the collectives).  A rank that raises
    gets the others killed and RuntimeError raised with its traceback.
    threads: `torch.set_num_threads` and OMP_NUM_THREADS in each rank.
    workdir: where the rendezvous store and the results are written (a
    new temporary directory, removed afterwards, when None).
    """
    ctx = mp.get_context('spawn')
    own = workdir is None
    base = tempfile.mkdtemp(prefix='admm_ranks_') if own else workdir
    run_dir = tempfile.mkdtemp(prefix='spawn_', dir=base)
    init_method = 'file://' + os.path.join(run_dir, 'store')
    procs = []
    try:
        with _omp_threads(threads):         # read by each child at start
            for rank in range(world):
                proc = ctx.Process(
                    target=_rank_main,
                    args=(rank, world, init_method, backend, timeout,
                          threads, fn, tuple(args), run_dir))
                proc.start()
                procs.append(proc)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            for rank, code in enumerate(codes):
                if code not in (None, 0):
                    err = os.path.join(run_dir, f'rank{rank}.err')
                    text = (open(err).read() if os.path.isfile(err)
                            else '(no traceback)')
                    raise RuntimeError(f'rank {rank} of {world} failed '
                                       f'(exit code {code}):\n{text}')
            if all(code == 0 for code in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f'{world} ranks did not finish within '
                                   f'{timeout} s')
            procs[codes.index(None)].join(0.05)
        return [torch.load(os.path.join(run_dir, f'rank{rank}.pt'),
                           map_location='cpu', weights_only=False)
                for rank in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(base if own else run_dir, ignore_errors=True)


@contextlib.contextmanager
def _omp_threads(threads: Optional[int]):
    saved = os.environ.get('OMP_NUM_THREADS')
    if threads:
        os.environ['OMP_NUM_THREADS'] = str(threads)
    try:
        yield
    finally:
        if threads:
            if saved is None:
                del os.environ['OMP_NUM_THREADS']
            else:
                os.environ['OMP_NUM_THREADS'] = saved



def run_cases(rank: int, world: int, calls: Sequence) -> List[object]:
    """The rank function of several runs in one process group: fn(**kw)
    for each (fn, kw) of `calls`, in order; fn is module-level, such as
    `api.train_sharded` or `run_layout`."""
    return [fn(**kw) for fn, kw in calls]


def run_layout(mesh_shape, config, parameter_set, params, data,
               epochs: int, axis_names=('data',), shard_time: bool = False,
               model_axis: Optional[str] = None, device='cuda') -> dict:
    """This rank's part of a sharded run under an explicit layout (the
    time-sharded and hidden-sharded ones of parallel/sharding.py, which no
    `api` entry point reaches), inside a process group.

    The whole initial state is built on the host from the whole batch
    (`init_admm_state` from `params`, the whole LSTMParams) and cut into
    this rank's block (`shard_state`), the carry-across path from JAX
    weights; then `epochs` epochs of `make_sharded_epoch_fn` on
    `shard_batch`'s inputs.  data: (train_x, train_y, val_x, val_y),
    numpy or tensors; the batch must split over the 'data' axis unless
    shard_time.

    Returns 'train_loss' and 'val_loss' after each epoch, 'rho' after each
    epoch ({key: float}), 'epoch_ms' (host clock; each epoch ends with the
    host reading its losses), 'state' (the whole final state,
    `gather_state`), 'round_trip' (whether gather_state(shard_state(the
    initial state)) is the initial state bit for bit), 'block' (this
    rank's slab shape) and 'mesh' (`Mesh.describe`, with the collectives
    of the epochs only)."""
    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.parallel.mesh import make_mesh
    from admm_lstm_torch.parallel.sharding import (gather_state,
                                                   make_sharded_epoch_fn,
                                                   shard_batch, shard_state)
    from admm_lstm_torch.utils.device import matmul_precision
    mesh = make_mesh(mesh_shape, axis_names, device=device)
    layout = dict(shard_time=shard_time, model_axis=model_axis)
    tx, ty, vx, vy = (torch.as_tensor(a).float() for a in data)
    with matmul_precision(config.matmul_precision):
        whole = init_admm_state(params.to('cpu'), tx, parameter_set, config)
        state = shard_state(whole, mesh, **layout)
        back = gather_state(state, mesh, **layout)
        round_trip = all(torch.equal(a, b) for ga, gb in
                         zip(back[:5], whole[:5]) for a, b in zip(ga, gb))
        x, y = shard_batch(tx, ty, mesh, shard_time)
        vx, vy = vx.to(mesh.device), vy.to(mesh.device)
        epoch = make_sharded_epoch_fn(config, mesh, **layout)
        mesh.consensus.reset_counts()
        mesh.model.reset_counts()
        train, val, rho, ends = [], [], [], [time.perf_counter()]
        for _ in range(epochs):
            state, metrics = epoch(state, x, y, vx, vy)
            train.append(float(metrics['train_loss']))
            val.append(float(metrics['val_loss']))
            ends.append(time.perf_counter())
            rho.append({k: float(v) for k, v in state.rho._asdict().items()})
        describe = mesh.describe()
        return dict(train_loss=train, val_loss=val, rho=rho,
                    epoch_ms=[1e3 * (b - a) for a, b in zip(ends, ends[1:])],
                    state=gather_state(state, mesh, **layout),
                    round_trip=round_trip, block=tuple(state.gates.h.shape),
                    mesh=describe)
