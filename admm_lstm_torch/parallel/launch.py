"""Starting the ranks of a data-parallel run on one host.

`spawn` starts one process per rank (torch.multiprocessing, 'spawn'),
joins them into a process group through a FileStore in a directory of
its own (no TCP port to collide on) and returns what each rank's
function returned.  A rank's function must be importable by the new
process: a module-level function, such as `train_cases`, which
`api.train_sharded` runs when it is called outside a process group.
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


def train_cases(rank: int, world: int, cases: Sequence[dict]) -> List[dict]:
    """The rank function of `api.train_sharded` outside a process group:
    `api.train_sharded(**case)` for each case in this rank, in order;
    returns each case's result."""
    from admm_lstm_torch.api import train_sharded
    return [train_sharded(**case) for case in cases]
