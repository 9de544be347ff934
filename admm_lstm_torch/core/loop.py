"""The chunked run loop of both models' training runs (`api.train` and
`variants/stacked.train_stacked`).

The JAX package runs each chunk of epochs as one compiled device program.
Here the chunk is a plain Python loop of a model's eager epochs
(`run_epochs`); the per-epoch metrics stay on the device until the end of the
chunk, so the chunk adds no host sync to the epoch's own (core/step.py
names them).  The loop adds those of its log lines, checkpoint saves and
convergence/divergence checks, and of its `collect` spans (the end-of-run
transfer).  The best-validation iterate is carried on the device
(`run_epochs`) and checked against the recorded trajectory at the end.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from admm_lstm_torch.utils.logging import info, warning
from admm_lstm_torch.utils.observe import span
from admm_lstm_torch.utils.timer import Timer

# The convergence/divergence checks run at least this often (epochs).
STOP_CHECK_EVERY = 25


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


def run_epochs(state, n: int, epoch_fn, best=None):
    """`n` epochs of `epoch_fn(state) -> (state, metrics)`, the metrics 0-d
    tensors, 'val_loss' among them; returns the state and each metric's
    (n,) trajectory, on the device.  `best`, a dict {'val': 0-d tensor,
    'params': LSTMParams or StackedParams}, is the best-validation carry,
    updated in place on the device after every epoch, with no host sync
    (NaN < best is False)."""
    hist = []
    for _ in range(n):
        state, metrics = epoch_fn(state)
        hist.append(metrics)
        if best is not None:
            better = metrics['val_loss'] < best['val']
            best['val'] = torch.where(better, metrics['val_loss'],
                                      best['val'])
            best['params'] = state.params.rebuild(
                torch.where(better, new, old) for new, old in
                zip(state.params.tensors(), best['params'].tensors()))
    return state, {k: torch.stack([m[k] for m in hist]) for k in hist[0]}


def run_chunked(label: str, state, epoch_fn, initial, epochs: int,
                start_epoch: int = 0,
                log_every: int = 1, checkpoint_every: int = 0, ckpt_mgr=None,
                stop_tol: Optional[float] = None,
                stop_divergence: Optional[float] = None,
                record_residuals: bool = False,
                track_best: bool = False) -> Dict[str, object]:
    """The epochs from `start_epoch` to `epochs` of `epoch_fn(state) ->
    (state, metrics)` (`run_epochs`), in chunks bounded by the host's sync
    points: log lines (log_every), checkpoint saves (checkpoint_every,
    when `ckpt_mgr` is given; closed at the end) and the
    convergence/divergence checks (at least every STOP_CHECK_EVERY
    epochs).  `initial` holds the (train, val) losses before the first
    epoch, logged after `label`.  track_best carries the best-validation
    iterate on the device from the initial one.

    stop_tol: stop once every primal AND dual residual (the r_*/s_*
    metrics) falls below this tolerance.  stop_divergence: stop once the
    maximum residual has grown past this factor of its running minimum.

    Returns 'train_loss', 'val_loss', 'residuals' (with record_residuals),
    'params' (the best iterate under track_best, else the last),
    'final_params', 'best_epoch', 'state' and 'seconds'.
    """
    info(f'{label}. Initial loss: train {initial[0]:.8f} | val '
         f'{initial[1]:.8f}')
    best = None
    if track_best:
        best = {'val': torch.tensor(initial[1], dtype=torch.float32,
                                    device=state.params.wy.device),
                'params': state.params.clone()}
    metric_hist = []
    timer = Timer()
    timer.start()
    epoch = start_epoch
    resid_floor = None
    checks = stop_tol is not None or stop_divergence is not None
    try:
        while epoch < epochs:
            chunk = epochs - epoch
            if log_every:
                chunk = min(chunk, log_every - epoch % log_every)
            if ckpt_mgr and checkpoint_every:
                chunk = min(chunk,
                            checkpoint_every - epoch % checkpoint_every)
            if checks:
                chunk = min(chunk, STOP_CHECK_EVERY)
            state, metrics = run_epochs(state, chunk, epoch_fn, best)
            metric_hist.append(metrics)
            epoch += chunk
            if checks:
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
                             f'{peak:.3e} grew past {stop_divergence:g}x '
                             f'its running minimum {resid_floor:.3e} '
                             f'(divergence guard).')
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
            with span('collect'):
                torch.cuda.synchronize(state.params.wy.device)
        timer.pause()
    finally:
        if ckpt_mgr:
            ckpt_mgr.close()

    with span('collect'):
        train_losses, val_losses, residual_log = _collect_metrics(
            metric_hist, initial, record_residuals)
    out_params, best_epoch = state.params, len(val_losses) - 1
    if track_best:
        out_params, best_epoch = _best_iterate(best, val_losses)
    info(f'Training has finished. Total time elapsed: '
         f'{timer.get_elapsed_time():.2f} seconds.')
    return {'train_loss': train_losses, 'val_loss': val_losses,
            'residuals': residual_log, 'params': out_params,
            'final_params': state.params, 'best_epoch': best_epoch,
            'state': state, 'seconds': timer.get_elapsed_time()}


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


def _best_iterate(best, val_losses):
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
    if best_epoch != len(val_losses) - 1:
        info(f'Best validation {bv:.8f} at epoch {best_epoch} '
             f'(final: {val_losses[-1]:.8f}); returning the best iterate.')
    return best['params'], best_epoch
