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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.residuals import admm_residuals
from admm_lstm_torch.core.state import ADMMState
from admm_lstm_torch.core.step import epoch_step, make_admm_step, rules_for
from admm_lstm_torch.models.lstm import (LSTMParams, init_lstm_params,
                                         train_val_mse_im)
from admm_lstm_torch.utils.config import (AUTO_FIELDS, LATER, ADMMConfig,
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
    (O, Bv)."""
    x_im = train_x.permute(1, 2, 0).contiguous()
    xall_im = torch.cat([x_im, val_x.permute(1, 2, 0)], dim=-1).contiguous()
    return x_im, train_y.T.contiguous(), xall_im, val_y.T.contiguous()


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
                        async_checkpoint: bool, device):
    """Resume and checkpoint bring-up (JAX api.py:79-108).  Returns
    (manager or None, state, start_epoch)."""
    from admm_lstm_torch.ckpt.checkpoint import CheckpointManager
    ckpt_mgr = None
    start_epoch = 0
    if resume_from or (checkpoint_dir and checkpoint_every):
        ckpt_mgr = CheckpointManager(resume_from or checkpoint_dir,
                                     async_save=async_checkpoint)
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
                ckpt_mgr = CheckpointManager(checkpoint_dir,
                                             async_save=async_checkpoint)
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

    Not in this slice of the port (NotImplementedError): configs that
    need a mesh or ADMM-L/-S.
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
    rules = rules_for(config)        # raises for configs not ported yet
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
           stop_divergence, track_best, device):
    if isinstance(parameter_set, dict):
        parameter_set = ParameterSet.from_dict(parameter_set)
    train_x, train_y = _as_tensor(train_x, device), _as_tensor(train_y, device)
    val_x, val_y = _as_tensor(val_x, device), _as_tensor(val_y, device)
    if params is None:
        gen = torch.Generator().manual_seed(config.seed)
        params = init_lstm_params(gen, train_x.shape[2], config.hidden_size,
                                  train_y.shape[1], device=device)

    state = init_admm_state(params.to(device), train_x, parameter_set, config)
    ckpt_mgr, state, start_epoch = _open_checkpointing(
        state, resume_from, checkpoint_dir, checkpoint_every,
        async_checkpoint, device)

    # The initial losses come from the epochs' one forward, so a resumed
    # run's first losses equal the uninterrupted run's at that epoch bit
    # for bit.
    x_im, y_im, xall_im, vy_im = batch_minor(train_x, train_y, val_x, val_y)
    initial = tuple(map(float, train_val_mse_im(state.params, xall_im, y_im,
                                                vy_im)))
    info(f'Training has started on {device}. Initial loss: train '
         f'{initial[0]:.8f} | val {initial[1]:.8f}')

    if stop_tol is not None or stop_divergence is not None:
        record_residuals = True

    best = None
    if track_best:
        best = {'val': torch.tensor(initial[1], dtype=torch.float32,
                                    device=device),
                'params': state.params.clone()}

    def run_chunk(st, n):
        hist = []
        for _ in range(n):
            st, metrics = epoch_step(st, x_im, y_im, xall_im, vy_im, rules,
                                     with_residuals=record_residuals)
            hist.append(metrics)
            if track_best:
                # NaN-safe on the device: NaN < best is False.
                better = metrics['val_loss'] < best['val']
                best['val'] = torch.where(better, metrics['val_loss'],
                                          best['val'])
                best['params'] = LSTMParams(*(
                    torch.where(better, new, old)
                    for new, old in zip(st.params, best['params'])))
        return st, {k: torch.stack([m[k] for m in hist]) for k in hist[0]}

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
    return {
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


def derive_auto_config(config: ADMMConfig) -> ADMMConfig:
    """`config` with the auto() composition (utils.config.AUTO_FIELDS)
    applied on top, keeping every problem-shaping field (hidden size,
    epochs, seed, dtype, variant)."""
    return config.replace(**AUTO_FIELDS)


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

    The legacy variants' candidate sets arrive in a later slice.
    """
    if config.variant in ('admm_l', 'admm_s'):
        raise NotImplementedError(
            f"preset='best' for variant {config.variant!r} arrives in "
            f'{LATER}')
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


def train_sharded(*args, **kwargs):
    """Data-parallel training over several cards: not in this slice."""
    raise NotImplementedError(f'train_sharded arrives in {LATER}')
