"""Checkpoint / resume of the full ADMM optimizer state.

Counterpart of `admm_lstm_tpu/ckpt/checkpoint.py`.  The reference can only
pickle the final trained module (`torch.save(model)`, demo.py:302-308)
and never persists optimizer state.  Here the complete `ADMMState` -
weights, every gate and dual slab, `a`, rho (adapted values included),
beta and the epoch counter - round-trips, so an interrupted run resumes
where it stopped and reproduces the uninterrupted trajectory bit for bit.

The format is the port's own, not the JAX package's orbax directories:
one `torch.save` file per step, `step_<N>.pt`, holding a dict of host
tensors and the epoch as an int, so `torch.load(..., weights_only=True)`
reads it back.

A data-parallel run (api.train_sharded) checkpoints through
`ShardedCheckpointManager`: rank 0 writes the same `step_<N>.pt` files of
the whole state, gathered through the host, and on resume every rank
reads the file and takes its own block of the batch.

`save_model`/`load_model` write and read final weights as `.npz` files
with the JAX package's keys (`x2{g}`, `h2{g}`, `wy`; `l{k}_*` per layer
of a stacked model), so a file written by either package loads in the
other.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

import numpy as np
import torch

from admm_lstm_torch.core.state import (ADMMState, DualSlabs, GateSlabs,
                                        Penalties, Ridges)
from admm_lstm_torch.models.lstm import (GATE_ORDER, LSTMParams,
                                         params_from_dict)
from admm_lstm_torch.utils.device import resolve_device
from admm_lstm_torch.utils.logging import info

_STEP_FILE = re.compile(r'^step_(\d+)\.pt$')
_GROUPS = (('params', LSTMParams), ('gates', GateSlabs),
           ('duals', DualSlabs), ('rho', Penalties), ('beta', Ridges))


def _to_host(state: ADMMState) -> Dict[str, object]:
    """The state as nested dicts of CPU tensors that share nothing with
    the device tensors.  A CUDA-to-host copy waits for the work that
    writes the tensor, so the result is complete when this returns."""
    out: Dict[str, object] = {'epoch': int(state.epoch)}
    for name, _ in _GROUPS:
        group = getattr(state, name)
        out[name] = {k: v.detach().to('cpu', copy=True)
                     for k, v in group._asdict().items()}
    return out


def _from_host(tree: Dict[str, object], device) -> ADMMState:
    fields = {name: cls(**{k: v.to(device) for k, v in tree[name].items()})
              for name, cls in _GROUPS}
    return ADMMState(epoch=int(tree['epoch']), **fields)


class CheckpointManager:
    """ADMMState checkpoints under a directory, the newest `max_to_keep`
    of them kept.

    With `async_save=True`, `save` copies the state to the host on the
    caller's thread and writes the file on a background thread, so the
    next epochs run while it serializes; `wait`, `close` and the next
    `save` join that thread.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False) -> None:
        if max_to_keep < 1:
            raise ValueError(f'max_to_keep must be at least 1, got '
                             f'{max_to_keep}')
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._async = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step}.pt')

    def _steps(self):
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def _write(self, tree: Dict[str, object], step: int) -> None:
        tmp = self._path(step) + '.tmp'
        torch.save(tree, tmp)
        os.replace(tmp, self._path(step))       # never a partial step file
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def _write_in_background(self, tree: Dict[str, object],
                             step: int) -> None:
        try:
            self._write(tree, step)
        except Exception as e:                  # raised again by wait()
            self._error = e

    def save(self, state: ADMMState, step: Optional[int] = None) -> None:
        step = int(state.epoch) if step is None else int(step)
        self.wait()
        tree = _to_host(state)
        if self._async:
            self._writer = threading.Thread(target=self._write_in_background,
                                            args=(tree, step), daemon=True)
            self._writer.start()
        else:
            self._write(tree, step)
        info(f'Checkpoint {"enqueued" if self._async else "saved"} at step '
             f'{step} -> {self.directory}')

    def wait(self) -> None:
        """Joins a pending background write; raises what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f'checkpoint write to {self.directory} '
                               f'failed') from error

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                device='cuda') -> ADMMState:
        """The state saved at `step` (default: the latest) on `device`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f'no checkpoints in {self.directory}')
        tree = torch.load(self._path(step), map_location='cpu',
                          weights_only=True)
        return _from_host(tree, resolve_device(device))

    def close(self) -> None:
        self.wait()


class ShardedCheckpointManager(CheckpointManager):
    """CheckpointManager for the ranks of a data-parallel run (`mesh`,
    parallel/mesh.py); every rank calls each method, in the same order.

    `save` gathers the whole state through the host (a collective), and
    rank 0 writes it as `CheckpointManager` does, on a background thread
    under `async_save`; every rank then waits on a barrier.  `restore`
    reads the file on every rank and returns this rank's block on its
    device.  The directory must be one that every rank sees.
    """

    def __init__(self, directory: str, mesh, max_to_keep: int = 3,
                 async_save: bool = False) -> None:
        super().__init__(directory, max_to_keep, async_save)
        self.mesh = mesh

    def save(self, state: ADMMState, step: Optional[int] = None) -> None:
        from admm_lstm_torch.parallel.sharding import gather_state
        whole = gather_state(state, self.mesh)
        if self.mesh.rank == 0:
            super().save(whole, step)
        self.mesh.barrier()

    def latest_step(self) -> Optional[int]:
        self.wait()                 # rank 0's pending write, if any
        self.mesh.barrier()
        return super().latest_step()

    def restore(self, step: Optional[int] = None,
                device=None) -> ADMMState:
        """This rank's block of the state saved at `step` (default: the
        latest), on the rank's device (`device` is not used)."""
        from admm_lstm_torch.parallel.sharding import shard_state
        return shard_state(super().restore(step, device='cpu'), self.mesh)

    def close(self) -> None:
        super().close()
        self.mesh.barrier()


def save_model(name: str, params, save_dir: str = 'SAVED_MODELS') -> str:
    """Final weights as `<save_dir>/<name>.npz` (reference:
    demo.py:302-308), with the JAX package's keys: x2i ... h2o and wy for
    LSTMParams; l{k}_x2i ... l{k}_h2o and l{k}_wy per layer and the head
    wy for the stacked variant's StackedParams."""
    from admm_lstm_torch.variants.stacked import StackedParams
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f'{name}.npz')
    host = lambda t: t.detach().cpu().numpy()
    arrays = {}
    if isinstance(params, StackedParams):
        blocks = [(f'l{k}_', layer) for k, layer in enumerate(params.layers)]
    else:
        blocks = [('', params)]
    for prefix, layer in blocks:
        for gi, g in enumerate(GATE_ORDER):
            arrays[f'{prefix}x2{g}'] = host(layer.wx[gi])
            arrays[f'{prefix}h2{g}'] = host(layer.wh[gi])
        arrays[f'{prefix}wy'] = host(layer.wy)
    arrays['wy'] = host(params.wy)
    np.savez(path, **arrays)
    info(f'{name}: Saved model to {path}.')
    return path


def load_model(path: str, device='cuda'):
    """Inverse of save_model: LSTMParams, or StackedParams for a file with
    l{k}_* keys, on `device`."""
    from admm_lstm_torch.variants.stacked import stacked_params_from_dict
    device = resolve_device(device)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    if any(k.startswith('l0_') for k in arrays):
        return stacked_params_from_dict(arrays, device=device)
    return params_from_dict(arrays, device=device)
