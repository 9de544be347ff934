"""High-level Python API.

Counterpart of `admm_lstm_tpu/api.py`: `ADMMBasedOptimizer` mirrors the
reference optimizer's usage contract (admm.py:22-78) and `train` is the
one-call training loop the CLI uses.

The JAX package runs each chunk of epochs as one compiled device program.
Here the chunk is a plain Python loop of eager epochs; the per-epoch
metrics stay on the device until the end of the chunk, so the only host
syncs inside an epoch are the line searches (solvers/prox_linear.py).
Entry points take `device` (default 'cuda') and raise when the card is
missing unless the caller asked for the CPU.  They set the process-wide
TF32 flags from `ADMMConfig.matmul_precision` for the work they run and
restore them afterwards.

`train_scenarios` trains S independent problems (the multi-ticker
scenario batch) in one batched program, as the JAX package vmaps them:
one state with the candidate axis (core/state.py), each scenario with its
own data and initial weights.

`train_sharded` is data-parallel consensus ADMM over `torch.distributed`
(parallel/): one process per rank, each holding a contiguous block of
the batch, the weights replicated.  Every batch sum of the epoch (the
weight and readout gradients, the line searches' objectives, the exact
stage's Gram systems, the residuals and the training loss) is
all-reduced inside the epoch, and the `a` update scales by the global
batch, so every rank follows the single-process trajectory up to the
order of the reductions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.residuals import admm_residuals
from admm_lstm_torch.core.state import ADMMState, unstack
from admm_lstm_torch.core.step import make_admm_step, rules_for, run_epochs
from admm_lstm_torch.models.lstm import (LSTMParams, init_lstm_params,
                                         train_val_mse_im)
from admm_lstm_torch.utils.config import (AUTO_FIELDS, ADMMConfig,
                                          ParameterSet)
from admm_lstm_torch.utils.device import matmul_precision, resolve_device
from admm_lstm_torch.utils.logging import info, log_assert, warning
from admm_lstm_torch.utils.timer import Timer


def _as_tensor(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def batch_minor(train_x, train_y, val_x, val_y):
    """The epoch's inputs, made once per run: x_im (T, I, B), y_im (O, B),
    xall_im (T, I, B + Bv) with the validation inputs appended along the
    batch (train and validation losses ride one forward) and vy_im
    (O, Bv); each with a leading S axis where the data has one (the
    scenario batch's (S, B, T, I), (S, B, O))."""
    x_im = train_x.movedim(-3, -1).contiguous()
    xall_im = torch.cat([x_im, val_x.movedim(-3, -1)], dim=-1).contiguous()
    return (x_im, train_y.transpose(-2, -1).contiguous(), xall_im,
            val_y.transpose(-2, -1).contiguous())


class ADMMBasedOptimizer:
    """Drop-in-feeling optimizer object around the functional core.

    Usage (mirrors demo.py:317-356):
        opt = ADMMBasedOptimizer(params, (train_x, train_y), parameter_set)
        for epoch in range(epochs):
            opt.step()
        trained = opt.params
    """

    def __init__(self, params: LSTMParams,
                 training_samples: Tuple[object, object],
                 parameter_set: ParameterSet | Dict,
                 config: ADMMConfig = ADMMConfig(),
                 verbose: bool = False, device='cuda') -> None:
        device = resolve_device(device)
        train_x, train_y = training_samples
        log_assert(train_x.ndim == 3 and train_y.ndim == 2,
                   f'Expected train_x (B,T,I) and train_y (B,O); got '
                   f'{tuple(train_x.shape)}, {tuple(train_y.shape)}')
        log_assert(train_x.shape[0] == train_y.shape[0],
                   f'Batch size mismatch: {train_x.shape[0]} vs {train_y.shape[0]}')
        log_assert(train_x.shape[2] == params.input_size
                   and train_y.shape[1] == params.output_size,
                   'Sample feature sizes must match the model')
        if isinstance(parameter_set, dict):
            parameter_set = ParameterSet.from_dict(parameter_set)
        self.config = config
        self.train_x = _as_tensor(train_x, device)
        self.train_y = _as_tensor(train_y, device)
        self._step_fn = make_admm_step(config)
        with matmul_precision(config.matmul_precision):
            self.state: ADMMState = init_admm_state(
                params.to(device), self.train_x, parameter_set, config)
        if verbose:
            info(f'ADMMBasedOptimizer[{config.variant}] B={train_x.shape[0]} '
                 f'T={train_x.shape[1]} I={train_x.shape[2]} '
                 f'H={params.hidden_size} O={params.output_size} on {device}')

    @property
    def params(self) -> LSTMParams:
        return self.state.params

    def step(self) -> None:
        """One ADMM epoch (the reference's optimizer.step(), admm.py:62)."""
        with matmul_precision(self.config.matmul_precision):
            self.state = self._step_fn(self.state, self.train_x, self.train_y)

    def residuals(self) -> Dict[str, torch.Tensor]:
        with matmul_precision(self.config.matmul_precision):
            return admm_residuals(self.state, self.train_x)


def _open_checkpointing(state: ADMMState, resume_from: Optional[str],
                        checkpoint_dir: Optional[str], checkpoint_every: int,
                        async_checkpoint: bool, device, mesh=None):
    """Resume and checkpoint bring-up (JAX api.py:79-108).  Returns
    (manager or None, state, start_epoch).  With a `mesh`, the managers
    are ShardedCheckpointManagers: rank 0 writes the whole state, and
    every rank resumes its own block."""
    from admm_lstm_torch.ckpt.checkpoint import (CheckpointManager,
                                                 ShardedCheckpointManager)

    def open_manager(directory):
        if mesh is None:
            return CheckpointManager(directory, async_save=async_checkpoint)
        return ShardedCheckpointManager(directory, mesh,
                                        async_save=async_checkpoint)

    ckpt_mgr = None
    start_epoch = 0
    if resume_from or (checkpoint_dir and checkpoint_every):
        ckpt_mgr = open_manager(resume_from or checkpoint_dir)
    if resume_from:
        if ckpt_mgr.latest_step() is None:
            info(f'No checkpoint found under {resume_from}; '
                 f'starting from scratch.')
        else:
            state = ckpt_mgr.restore(device=device)
            start_epoch = state.epoch
            info(f'Resumed from {resume_from} at epoch {start_epoch}.')
        if resume_from != checkpoint_dir or not checkpoint_every:
            ckpt_mgr.close()
            ckpt_mgr = None
            if checkpoint_dir and checkpoint_every:
                ckpt_mgr = open_manager(checkpoint_dir)
    return ckpt_mgr, state, start_epoch


def _run_chunked(state, run_chunk, epochs: int, start_epoch: int,
                 log_every: int, checkpoint_every: int, ckpt_mgr,
                 timer: Timer, stop_tol: Optional[float] = None,
                 stop_check_every: int = 25,
                 stop_divergence: Optional[float] = None):
    """The epoch loop from `start_epoch`, in chunks bounded by the host's
    sync points: log lines (log_every), checkpoint saves
    (checkpoint_every, when `ckpt_mgr` is given) and the
    convergence/divergence checks (at least every `stop_check_every`
    epochs).

    run_chunk(state, n) -> (state, metrics with a leading (n,) axis, on
    the device).  Returns (state, metric_hist).

    stop_tol: stop once every primal AND dual residual (the r_*/s_*
    metrics) falls below this tolerance.  stop_divergence: stop once the
    maximum residual has grown past this factor of its running minimum.
    """
    metric_hist = []
    timer.start()
    epoch = start_epoch
    resid_floor = None
    while epoch < epochs:
        chunk = epochs - epoch
        if log_every:
            chunk = min(chunk, log_every - epoch % log_every)
        if ckpt_mgr and checkpoint_every:
            chunk = min(chunk, checkpoint_every - epoch % checkpoint_every)
        if stop_tol is not None or stop_divergence is not None:
            chunk = min(chunk, stop_check_every)
        state, metrics = run_chunk(state, chunk)
        metric_hist.append(metrics)
        epoch += chunk
        if stop_tol is not None or stop_divergence is not None:
            resid = [float(v[-1]) for k, v in metrics.items()
                     if k.startswith(('r_', 's_'))]
            if stop_tol is not None and resid and max(resid) < stop_tol:
                info(f'Converged at epoch {epoch}: every ADMM residual '
                     f'below {stop_tol} (max {max(resid):.3e}).')
                break
            if stop_divergence is not None and resid:
                peak = max(resid)
                resid_floor = (peak if resid_floor is None
                               else min(resid_floor, peak))
                if peak > stop_divergence * resid_floor:
                    info(f'Stopping at epoch {epoch}: max ADMM residual '
                         f'{peak:.3e} grew past {stop_divergence:g}x its '
                         f'running minimum {resid_floor:.3e} (divergence '
                         f'guard).')
                    break
        if log_every and epoch % log_every == 0:
            timer.pause()
            done = epoch - start_epoch
            info(f'Epoch {epoch} has done in '
                 f'{timer.get_elapsed_time() * 1e3 / done:.3f} ms (avg). '
                 f'Present loss: Training: '
                 f'{float(metrics["train_loss"][-1]):.8f} '
                 f'| Validation: {float(metrics["val_loss"][-1]):.8f}.')
            timer.resume()
        if ckpt_mgr and epoch % checkpoint_every == 0:
            ckpt_mgr.save(state, step=epoch)
    if state.params.wy.is_cuda:
        torch.cuda.synchronize(state.params.wy.device)
    timer.pause()
    return state, metric_hist


def _collect_metrics(metric_hist, initial, record_residuals):
    """Stack per-chunk metric trajectories into host lists (one device
    concat + one transfer per metric)."""
    stacked = {k: torch.cat([m[k] for m in metric_hist]).cpu().numpy()
               for k in metric_hist[0]} if metric_hist else {}
    train_losses = [initial[0]] + list(map(float,
                                           stacked.get('train_loss', [])))
    val_losses = [initial[1]] + list(map(float, stacked.get('val_loss', [])))
    residual_log = []
    if record_residuals and metric_hist:
        keys = [k for k in metric_hist[0] if k.startswith(('r_', 's_'))]
        for j in range(len(stacked[keys[0]]) if keys else 0):
            residual_log.append({k: float(stacked[k][j]) for k in keys})
    return train_losses, val_losses, residual_log


def _best_iterate(best, val_losses, final_params, announce=True):
    """The track_best epilogue: the on-device carry's params are the
    min-validation iterate by construction, so return them with
    best_epoch = argmin.  A drift between the carry and the recorded
    trajectory is a bug and raises.  A non-finite trajectory falls back to
    the carry, which still holds the best finite iterate."""
    bv = float(best['val'])
    finite = [v for v in val_losses if np.isfinite(v)]
    if len(finite) != len(val_losses):
        warning(f'validation trajectory contains non-finite losses '
                f'({len(val_losses) - len(finite)} of {len(val_losses)}); '
                f'returning the best finite iterate (val {bv:.8f}).')
        best_epoch = int(np.nanargmin(np.asarray(val_losses))) \
            if finite else 0
        if finite and bv < min(finite) - 1e-12:
            warning(f'best-iterate carry ({bv}) is below the recorded '
                    f'finite minimum ({min(finite)}); best_epoch is '
                    f'approximate.')
        return best['params'], best_epoch
    if bv > min(val_losses) + 1e-12:
        raise RuntimeError(
            f'best-iterate carry ({bv}) drifted above the recorded '
            f'trajectory minimum ({min(val_losses)})')
    best_epoch = int(np.argmin(val_losses))
    if announce and best_epoch != len(val_losses) - 1:
        info(f'Best validation {bv:.8f} at epoch {best_epoch} '
             f'(final: {val_losses[-1]:.8f}); returning the best iterate.')
    return best['params'], best_epoch


def train(train_x, train_y, val_x, val_y,
          parameter_set: ParameterSet | Dict,
          config: ADMMConfig = ADMMConfig(),
          params: Optional[LSTMParams] = None,
          log_every: int = 1,
          record_residuals: bool = False,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0,
          resume_from: Optional[str] = None,
          async_checkpoint: bool = True,
          stop_tol: Optional[float] = None,
          stop_divergence: Optional[float] = None,
          track_best: bool = False,
          preset: Optional[str] = None,
          device='cuda') -> Dict[str, object]:
    """Full training loop: returns loss trajectories + final params.

    Arrays may be numpy or tensors; they are moved to `device` ('cuda'
    by default; the CPU only when asked).  `params` defaults to a
    Xavier-normal init from `torch.Generator().manual_seed(config.seed)`.

    track_best: carry the best-validation iterate on the device and return
    it as 'params' ('final_params' keeps the last iterate, 'best_epoch'
    records where the best was).  stop_tol / stop_divergence: see
    _run_chunked; both imply residual recording.

    Returns a dict with 'name', 'train_loss', 'val_loss' (the reference's
    admm_demo shape, demo.py:371-376) plus 'residuals', 'params',
    'final_params', 'best_epoch', 'state', 'seconds'.

    preset='best': the probe-and-commit recipe, `train_best`.

    checkpoint_dir/checkpoint_every: save the full ADMM state every
    `checkpoint_every` epochs (ckpt/checkpoint.py; `async_checkpoint`
    writes the files on a background thread).  resume_from: a checkpoint
    directory to restore the latest state from; training continues at
    the restored epoch, the loss lists start there, and the run ends bit
    for bit where the uninterrupted one does.

    `config.mesh_shape` is ignored here, as in the JAX package: a mesh
    trains data-parallel through `train_sharded`.  ADMM-L and ADMM-S train through their own demos
    (variants/admm_l.py, variants/admm_s.py) or train_best.
    """
    if preset is not None:
        if preset != 'best':
            raise ValueError(f"preset must be None or 'best', got {preset!r}")
        return train_best(
            train_x, train_y, val_x, val_y, parameter_set, config=config,
            params=params, log_every=log_every,
            divergence_guard=(stop_divergence if stop_divergence is not None
                              else 3.0),
            record_residuals=record_residuals,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            resume_from=resume_from, async_checkpoint=async_checkpoint,
            stop_tol=stop_tol, device=device)
    rules = rules_for(config)        # raises for the legacy variants
    device = resolve_device(device)
    with matmul_precision(config.matmul_precision):
        return _train(train_x, train_y, val_x, val_y, parameter_set, config,
                      rules, params, log_every, record_residuals,
                      checkpoint_dir, checkpoint_every, resume_from,
                      async_checkpoint, stop_tol, stop_divergence,
                      track_best, device)


def _train(train_x, train_y, val_x, val_y, parameter_set, config, rules,
           params, log_every, record_residuals, checkpoint_dir,
           checkpoint_every, resume_from, async_checkpoint, stop_tol,
           stop_divergence, track_best, device, mesh=None):
    """`train`'s loop; with a `mesh` (train_sharded), on this rank's block
    of the padded batch, with `rules` carrying the mesh's consensus."""
    if isinstance(parameter_set, dict):
        parameter_set = ParameterSet.from_dict(parameter_set)
    if mesh is None:
        train_x, train_y = (_as_tensor(train_x, device),
                            _as_tensor(train_y, device))
    else:
        from admm_lstm_torch.parallel.sharding import pad_batch, shard_batch
        train_x, train_y = shard_batch(
            *pad_batch(train_x, train_y, mesh.world), mesh)
    val_x, val_y = _as_tensor(val_x, device), _as_tensor(val_y, device)
    if params is None:
        gen = torch.Generator().manual_seed(config.seed)
        params = init_lstm_params(gen, train_x.shape[2], config.hidden_size,
                                  train_y.shape[1], device=device)

    state = init_admm_state(params.to(device), train_x, parameter_set, config)
    ckpt_mgr, state, start_epoch = _open_checkpointing(
        state, resume_from, checkpoint_dir, checkpoint_every,
        async_checkpoint, device, mesh)
    if state.batch_size != train_x.shape[0]:
        raise ValueError(f'the checkpoint under {resume_from} holds a batch '
                         f'of {state.batch_size} (per rank), the run '
                         f'{train_x.shape[0]}')

    # The initial losses come from the epochs' one forward, so a resumed
    # run's first losses equal the uninterrupted run's at that epoch bit
    # for bit.
    x_im, y_im, xall_im, vy_im = batch_minor(train_x, train_y, val_x, val_y)
    initial = tuple(map(float, train_val_mse_im(state.params, xall_im, y_im,
                                                vy_im, rules.consensus)))
    where = (device if mesh is None else
             f'{mesh.world} ranks ({mesh.backend}; this one on {device})')
    info(f'Training has started on {where}. Initial loss: train '
         f'{initial[0]:.8f} | val {initial[1]:.8f}')

    if stop_tol is not None or stop_divergence is not None:
        record_residuals = True

    best = None
    if track_best:
        best = {'val': torch.tensor(initial[1], dtype=torch.float32,
                                    device=device),
                'params': state.params.clone()}

    def run_chunk(st, n):
        return run_epochs(st, n, x_im, y_im, xall_im, vy_im, rules,
                          with_residuals=record_residuals, best=best)

    timer = Timer()
    try:
        state, metric_hist = _run_chunked(
            state, run_chunk, config.epochs, start_epoch, log_every,
            checkpoint_every, ckpt_mgr, timer, stop_tol=stop_tol,
            stop_divergence=stop_divergence)
    finally:
        if ckpt_mgr:
            ckpt_mgr.close()

    train_losses, val_losses, residual_log = _collect_metrics(
        metric_hist, initial, record_residuals)

    out_params = state.params
    best_epoch = len(val_losses) - 1
    if track_best:
        out_params, best_epoch = _best_iterate(best, val_losses,
                                               state.params)

    info(f'Training has finished. Total time elapsed: '
         f'{timer.get_elapsed_time():.2f} seconds.')
    result = {
        'name': 'Fast ADMM-LSTM' if config.variant == 'fast' else config.variant,
        'train_loss': train_losses,
        'val_loss': val_losses,
        'residuals': residual_log,
        'params': out_params,
        'final_params': state.params,
        'best_epoch': best_epoch,
        'state': state,
        'seconds': timer.get_elapsed_time(),
    }
    if mesh is not None:
        from admm_lstm_torch.parallel.sharding import gather_state
        result['state'] = gather_state(state, mesh)
        result['mesh'] = mesh.describe()
    return result


def derive_auto_config(config: ADMMConfig) -> ADMMConfig:
    """`config` with the auto() composition (utils.config.AUTO_FIELDS)
    applied on top, keeping every problem-shaping field (hidden size,
    epochs, seed, dtype, variant)."""
    return config.replace(**AUTO_FIELDS)


def _train_best_legacy(train_x, train_y, val_x, val_y, config: ADMMConfig,
                       probe_epochs: int, log_every: int,
                       device='cuda') -> Dict[str, object]:
    """preset='best' for ADMM-L and ADMM-S (JAX api.py:397-442): probe a
    small per-variant candidate set of their own rule constants for
    min(probe_epochs, epochs) epochs, each from the variant's seeded init,
    rank them by their probe's best validation loss and commit to the
    winner for the full budget.  ADMM-L's candidates move the output-fit
    penalty rho11, ADMM-S's the h-update damping r_h (the knobs that moved
    each on GoogleStock, per the JAX package).

    Returns the committed demo run's result, with 'preset_choice' and
    'probe_val'."""
    if config.variant == 'admm_l':
        from admm_lstm_torch.variants.admm_l import ADMMLRules, admm_l_demo
        candidates = {'reference': ADMMLRules(),
                      'rho11_1e-3': ADMMLRules(rho11=1e-3),
                      'rho11_1e-5': ADMMLRules(rho11=1e-5)}
        demo = admm_l_demo
    else:
        from admm_lstm_torch.variants.admm_s import ADMMSRules, admm_s_demo
        candidates = {'reference': ADMMSRules(),
                      'r_h_25': ADMMSRules(r_h=25.0),
                      'r_h_10': ADMMSRules(r_h=10.0)}
        demo = admm_s_demo

    def runner(epochs, rules, log_every):
        return demo(epochs, config.hidden_size, train_x, train_y, val_x,
                    val_y, seed=config.seed, rules=rules,
                    log_every=log_every, device=device)

    n_probe = max(1, min(probe_epochs, config.epochs))
    probe_val: Dict[str, float] = {}
    for name, rules in candidates.items():
        res = runner(n_probe, rules, 0)
        probe_val[name] = float(min(res['val_loss']))
    winner = min(probe_val, key=probe_val.get)
    info(f"preset='best' [{config.variant}]: probe {n_probe} epochs -> "
         + ', '.join(f'{k} {v:.6g}' for k, v in probe_val.items())
         + f'; committing to {winner}.')
    result = runner(config.epochs, candidates[winner], log_every)
    result['preset_choice'] = winner
    result['probe_val'] = probe_val
    return result


def train_best(train_x, train_y, val_x, val_y,
               parameter_set: ParameterSet | Dict,
               config: ADMMConfig = ADMMConfig(),
               params: Optional[LSTMParams] = None,
               probe_epochs: int = 15,
               divergence_guard: float = 3.0,
               search_rounds: int = 0,
               log_every: int = 1,
               device='cuda',
               **train_kw) -> Dict[str, object]:
    """The per-dataset quality recipe as one entry point
    (train(preset='best'); JAX api.py:507-613).

    Probe each candidate - the shipped tuning as `config` says, and
    `derive_auto_config(config)` - for a quarter of the budget (at least
    `probe_epochs`) from the same initial weights, with the on-device
    best-iterate carry and the divergence guard; commit to the one with
    the lower best validation loss and rerun it for the full budget the
    same way.

    search_rounds > 0 adds a third candidate, 'tuned': the shipped config
    with the rho that `search_rounds` rounds of `tune.refine_rho` at the
    probe length find.

    Returns the committed run's `train` result, with 'preset_choice' (the
    winning candidate's name) and 'probe_val' (each candidate's probe best
    validation loss).

    For the legacy variants (config.variant 'admm_l' or 'admm_s') it runs
    `_train_best_legacy` instead; they keep no checkpoints, so
    checkpoint arguments raise ValueError there.
    """
    if config.variant in ('admm_l', 'admm_s'):
        # The legacy re-derivations have their own rule constants and
        # training loops; the probe-and-commit recipe carries over, the
        # candidates are per variant.
        if train_kw.get('resume_from') or train_kw.get('checkpoint_dir'):
            raise ValueError("preset='best' checkpointing is a "
                             'fast/no_dual_y feature; the legacy variants '
                             'do not persist optimizer state')
        return _train_best_legacy(train_x, train_y, val_x, val_y, config,
                                  probe_epochs, log_every, device)
    if train_kw.get('resume_from'):
        raise ValueError(
            "resume_from is incompatible with preset='best': the probe "
            'phase may commit to a different candidate than the config '
            'that wrote the checkpoint.  Resume via train(...) with the '
            "run's recorded preset_choice applied explicitly.")
    device = resolve_device(device)
    if isinstance(parameter_set, dict):
        parameter_set = ParameterSet.from_dict(parameter_set)
    if params is None:
        gen = torch.Generator().manual_seed(config.seed)
        params = init_lstm_params(gen, np.shape(train_x)[2],
                                  config.hidden_size, np.shape(train_y)[1],
                                  device=device)

    candidates = {'shipped': (config, parameter_set),
                  'auto': (derive_auto_config(config), parameter_set)}
    n_probe = max(1, min(config.epochs,
                         max(probe_epochs, config.epochs // 4)))
    if search_rounds:
        from admm_lstm_torch.tune import refine_rho
        tuned = refine_rho(train_x, train_y, val_x, val_y, parameter_set,
                           config=config, epochs=n_probe,
                           rounds=search_rounds, params=params,
                           device=device)
        candidates['tuned'] = (config, tuned['best_parameter_set'])
    probe_val: Dict[str, float] = {}
    for name, (cand, pset) in candidates.items():
        res = train(train_x, train_y, val_x, val_y, pset,
                    config=cand.replace(epochs=n_probe), params=params,
                    log_every=0, track_best=True,
                    stop_divergence=divergence_guard, device=device)
        v = float(np.nanmin(np.asarray(res['val_loss'])))
        probe_val[name] = v if np.isfinite(v) else float('inf')
    winner = min(probe_val, key=probe_val.get)
    info(f"preset='best': probe {n_probe} epochs -> "
         + ', '.join(f'{k} {v:.6g}' for k, v in probe_val.items())
         + f'; committing to {winner}.')

    win_cfg, win_pset = candidates[winner]
    result = train(train_x, train_y, val_x, val_y, win_pset,
                   config=win_cfg, params=params,
                   log_every=log_every, track_best=True,
                   stop_divergence=divergence_guard, device=device,
                   **train_kw)
    result['preset_choice'] = winner
    result['probe_val'] = probe_val
    return result


def train_best_stacked(train_x, train_y, val_x, val_y,
                       parameter_set: ParameterSet | Dict,
                       config: ADMMConfig = ADMMConfig(),
                       hiddens=None,
                       probe_epochs: int = 15,
                       search_rounds: int = 1,
                       log_every: int = 1,
                       params=None,
                       device='cuda') -> Dict[str, object]:
    """preset='best' for the stacked N-layer variant (JAX api.py:445-505):
    probe the shipped tuning against the winner of
    `tune.refine_rho_stacked` over the c/h/y penalties, from the same
    initial weights, and commit to the one with the lower probe
    validation loss for the full budget, with the best-iterate carry.

    The probe and search budget is max(probe_epochs, epochs // 4) (at
    most the budget), with a second search round once that reaches 100
    epochs: short probes do not rank the stack's tunings for long runs.
    Each probe is ranked by its trajectory's nan-min.  `params`: the
    initial StackedParams (default: `init_stacked` from
    `torch.Generator().manual_seed(config.seed)`).

    Returns the committed `train_stacked` result, with 'preset_choice',
    'probe_val' (each candidate's probe validation loss) and
    'candidate_rho' (each candidate's rho, 'z' included).
    """
    from admm_lstm_torch.variants.stacked import init_stacked, train_stacked
    device = resolve_device(device)
    if isinstance(parameter_set, dict):
        parameter_set = ParameterSet.from_dict(parameter_set)
    if params is None:
        if hiddens is None:
            hiddens = (config.hidden_size, config.hidden_size)
        params = init_stacked(torch.Generator().manual_seed(config.seed),
                              np.shape(train_x)[2], tuple(hiddens),
                              np.shape(train_y)[1], device=device)
    hiddens = tuple(lp.hidden_size for lp in params.layers)
    n_probe = max(1, min(config.epochs,
                         max(probe_epochs, config.epochs // 4)))

    candidates = {'shipped': parameter_set}
    if search_rounds:
        from admm_lstm_torch.tune import refine_rho_stacked
        n_rounds = max(search_rounds, 2) if n_probe >= 100 else search_rounds
        tuned = refine_rho_stacked(train_x, train_y, val_x, val_y,
                                   parameter_set, hiddens, config=config,
                                   epochs=n_probe, rounds=n_rounds,
                                   params=params, device=device)
        candidates['tuned'] = tuned['best_parameter_set']
    probe_val: Dict[str, float] = {}
    for name, pset in candidates.items():
        res = train_stacked(train_x, train_y, val_x, val_y, pset,
                            config.replace(epochs=n_probe), log_every=0,
                            params=params, device=device)
        v = float(np.nanmin(np.asarray(res['val_loss'])))
        probe_val[name] = v if np.isfinite(v) else float('inf')
    winner = min(probe_val, key=probe_val.get)
    info(f"preset='best' [stacked {hiddens}]: probe {n_probe} epochs -> "
         + ', '.join(f'{k} {v:.6g}' for k, v in probe_val.items())
         + f'; committing to {winner}.')
    result = train_stacked(train_x, train_y, val_x, val_y,
                           candidates[winner], config, log_every=log_every,
                           params=params, device=device)
    result['preset_choice'] = winner
    result['probe_val'] = probe_val
    result['candidate_rho'] = {name: dict(pset.rho)
                               for name, pset in candidates.items()}
    return result


def scenario_generator(seed: int, scenario: int) -> torch.Generator:
    """The generator of scenario `scenario`'s initial weights, seeded from
    (seed, scenario) (JAX splits PRNGKey(seed), which torch cannot
    reproduce)."""
    state = np.random.SeedSequence((seed, scenario)).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def scenario_inits(seed: int, count: int, input_size: int, hidden: int,
                   output_size: int, device='cuda') -> LSTMParams:
    """The default initial weights of `count` scenarios, stacked on a
    leading axis: scenario s draws `init_lstm_params` from
    `scenario_generator(seed, s)`."""
    inits = [init_lstm_params(scenario_generator(seed, s), input_size,
                              hidden, output_size, device=device)
             for s in range(count)]
    return LSTMParams(*(torch.stack(leaves) for leaves in zip(*inits)))


def train_scenarios(xs, ys, vxs, vys,
                    parameter_set: ParameterSet | Dict,
                    config: ADMMConfig = ADMMConfig(),
                    params: Optional[LSTMParams] = None,
                    device='cuda') -> Dict[str, object]:
    """Train S independent ADMM instances (JAX api.py:616-674; BASELINE
    config 3, the multi-ticker scenario batch).

    xs (S,B,T,I), ys (S,B,O), vxs (S,Bv,T,I), vys (S,Bv,O): one training
    problem per scenario.  `params`: the S initial weights as LSTMParams
    whose leaves have a leading S axis (default: `scenario_inits` of
    `config.seed`).

    The JAX package vmaps the S instances into one program, its line
    searches masked per instance, under any config.  So does this one, on
    `device`: one state with the candidate axis, `run_epochs` over it
    (one sweep launch an epoch for all S, Gauss-Seidel or Jacobi, and
    under turbo()/auto() one batched Cholesky solve a weight stage), the
    line searches per scenario, so each scenario's numbers are those of a
    run alone, as JAX's are.  The losses come from `train_val_mse_im`'s
    one forward (JAX calls `mse_loss` twice; the values agree) and stay
    on the device until every scenario has run.

    Returns 'name', 'train_loss' and 'val_loss' (numpy (S, epochs+1)),
    'params' (LSTMParams with a leading S axis), 'state' (the list of the
    S final ADMMStates, sliced from the batched one: `epoch` is one host
    int) and 'seconds'.
    """
    rules = rules_for(config)
    device = resolve_device(device)
    if isinstance(parameter_set, dict):
        parameter_set = ParameterSet.from_dict(parameter_set)
    xs, ys, vxs, vys = (_as_tensor(a, device) for a in (xs, ys, vxs, vys))
    n_scen = xs.shape[0]
    if params is None:
        params = scenario_inits(config.seed, n_scen, xs.shape[3],
                                config.hidden_size, ys.shape[2], device)
    params = params.to(device)

    timer = Timer()
    with matmul_precision(config.matmul_precision):
        timer.start()
        x_im, y_im, xall_im, vy_im = batch_minor(xs, ys, vxs, vys)
        state = init_admm_state(params, xs, parameter_set, config)
        initial = train_val_mse_im(state.params, xall_im, y_im, vy_im)
        state, hist = run_epochs(state, config.epochs, x_im, y_im, xall_im,
                                 vy_im, rules)
        states = unstack(state)
        train_np, val_np = (
            torch.cat([initial[k][None], hist[name]]).T.cpu().numpy()
            for k, name in enumerate(('train_loss', 'val_loss')))
        timer.pause()
    info(f'{n_scen} scenarios x {config.epochs} epochs in one batched '
         f'program: {timer.get_elapsed_time():.2f}s; final val '
         f'{[round(float(v), 6) for v in val_np[:, -1]]}')
    return {
        'name': f'Scenario ADMM-LSTM [{config.variant}]',
        'train_loss': train_np,
        'val_loss': val_np,
        'params': state.params,
        'state': states,
        'seconds': timer.get_elapsed_time(),
    }


def train_sharded(train_x, train_y, val_x, val_y,
                  parameter_set: ParameterSet | Dict,
                  config: ADMMConfig = ADMMConfig(),
                  params: Optional[LSTMParams] = None,
                  log_every: int = 1, record_residuals: bool = False,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 0,
                  resume_from: Optional[str] = None,
                  async_checkpoint: bool = True,
                  stop_tol: Optional[float] = None,
                  stop_divergence: Optional[float] = None,
                  track_best: bool = False,
                  device='cuda',
                  backend: Optional[str] = None) -> Dict[str, object]:
    """Data-parallel training over `config.mesh_shape` = (n,) or
    (n, n_model) ranks (JAX api.py:677-791): `train`'s loop and result on
    each rank's block of the batch, with every batch sum all-reduced over
    the 'data' axis inside the epoch.  On a 2-D mesh the 'model' ranks are
    replicas of their data block, as in the JAX package, which places the
    state with the data axis only (api.py:723): the sums are all-reduced
    over 'data' alone, so that replicas do not double them.

    The batch is padded to a multiple of the mesh's ranks with duplicated
    tail samples (JAX's index formula, api.py:713-722); data rank d holds
    samples [d*B/n, (d+1)*B/n) and the validation arrays whole.  The weights stay bit-equal across the
    ranks, because every rank computes them from the same all-reduced
    sums.  Checkpoints are `train`'s `step_<N>.pt` files of the whole
    state, written by rank 0 (gathered through the host); a resume reads
    them on every rank and takes its own block.

    Two modes:
      * inside an initialized process group (torchrun, or
        `parallel.initialize_multihost`): this rank's part of the run,
        SPMD, on `device` ('cuda': the card LOCAL_RANK, else the rank,
        modulo the host's cards);
      * outside one: it starts n local ranks (torch.multiprocessing) and
        returns rank 0's result, with its tensors on the CPU.  `backend`
        None takes NCCL on the card when each rank has a card of its
        own, gloo on the CPU, and raises where ranks would share a card:
        ask for 'gloo' there (parallel.mesh.backend_for).

    Returns `train`'s keys, with 'state' the whole state gathered to the
    host and 'mesh' a description of the ranks and this rank's
    collectives.  The time-sharded and hidden-sharded layouts have no
    entry point here, as in the JAX package: parallel/sharding.py reaches
    them.
    """
    import math

    import torch.distributed as dist

    from admm_lstm_torch.parallel.mesh import backend_for, make_mesh
    rules = rules_for(config)
    if config.mesh_shape is not None and len(config.mesh_shape) > 2:
        raise ValueError(f'mesh_shape {tuple(config.mesh_shape)}: a mesh '
                         f'has one axis (data) or two (data, model)')
    if not dist.is_initialized():
        from admm_lstm_torch.parallel.launch import run_cases, spawn
        if config.mesh_shape is None:
            raise ValueError('train_sharded outside a process group needs '
                             'config.mesh_shape = (n,), the ranks to start')
        world = math.prod(config.mesh_shape)
        backend = backend_for(device, world, backend)
        arrays = [a.detach().cpu() if isinstance(a, torch.Tensor) else a
                  for a in (train_x, train_y, val_x, val_y)]
        case = dict(
            zip(('train_x', 'train_y', 'val_x', 'val_y'), arrays),
            parameter_set=parameter_set, config=config,
            params=None if params is None else params.to('cpu'),
            log_every=log_every, record_residuals=record_residuals,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            resume_from=resume_from, async_checkpoint=async_checkpoint,
            stop_tol=stop_tol, stop_divergence=stop_divergence,
            track_best=track_best, device=device)
        return spawn(run_cases, world, args=([(train_sharded, case)],),
                     backend=backend)[0][0]
    mesh = make_mesh(config.mesh_shape, config.mesh_axes, device=device)
    rules = dataclasses.replace(rules, consensus=mesh.consensus)
    with matmul_precision(config.matmul_precision):
        return _train(train_x, train_y, val_x, val_y, parameter_set, config,
                      rules, params, log_every, record_residuals,
                      checkpoint_dir, checkpoint_every, resume_from,
                      async_checkpoint, stop_tol, stop_divergence,
                      track_best, mesh.device, mesh)
