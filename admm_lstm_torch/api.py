"""High-level Python API.

Counterpart of `admm_lstm_tpu/api.py`: `ADMMBasedOptimizer` mirrors the
reference optimizer's usage contract (admm.py:22-78) and `train` is the
one-call training loop the CLI uses.

A run's epochs go through the chunked loop of core/loop.py, which adds
no host sync to the epoch's own (core/step.py names them) but its log
lines, checks and `collect` spans.  A run adds those of its `init` span
(the penalties' host values copied to the device, the initial losses
read), inside its `train` span.
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
from admm_lstm_torch.core.loop import batch_minor, run_chunked
from admm_lstm_torch.core.residuals import admm_residuals
from admm_lstm_torch.core.state import ADMMState, unstack
from admm_lstm_torch.core.step import (epoch_step, make_admm_step,
                                       rules_for, run_epochs)
from admm_lstm_torch.models.lstm import (LSTMParams, init_lstm_params,
                                         train_val_mse_im)
from admm_lstm_torch.utils.config import (AUTO_FIELDS, ADMMConfig,
                                          ParameterSet)
from admm_lstm_torch.utils.device import (as_tensor, matmul_precision,
                                          resolve_device)
from admm_lstm_torch.utils.logging import info, log_assert
from admm_lstm_torch.utils.observe import span
from admm_lstm_torch.utils.timer import Timer


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
        self.train_x = as_tensor(train_x, device)
        self.train_y = as_tensor(train_y, device)
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
    core/loop.run_chunked; both imply residual recording.

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
    with matmul_precision(config.matmul_precision), span('train'):
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
    with span('init'):
        if mesh is None:
            train_x, train_y = (as_tensor(train_x, device),
                                as_tensor(train_y, device))
        else:
            from admm_lstm_torch.parallel.sharding import (pad_batch,
                                                           shard_batch)
            train_x, train_y = shard_batch(
                *pad_batch(train_x, train_y, mesh.world), mesh)
        val_x, val_y = as_tensor(val_x, device), as_tensor(val_y, device)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed)
            params = init_lstm_params(gen, train_x.shape[2],
                                      config.hidden_size, train_y.shape[1],
                                      device=device)

        state = init_admm_state(params.to(device), train_x, parameter_set,
                                config)
        ckpt_mgr, state, start_epoch = _open_checkpointing(
            state, resume_from, checkpoint_dir, checkpoint_every,
            async_checkpoint, device, mesh)
        if state.batch_size != train_x.shape[0]:
            raise ValueError(f'the checkpoint under {resume_from} holds a '
                             f'batch of {state.batch_size} (per rank), the '
                             f'run {train_x.shape[0]}')

        # The initial losses come from the epochs' one forward, so a
        # resumed run's first losses equal the uninterrupted run's at that
        # epoch bit for bit.
        x_im, y_im, xall_im, vy_im = batch_minor(train_x, train_y, val_x,
                                                 val_y)
        initial = tuple(map(float, train_val_mse_im(
            state.params, xall_im, y_im, vy_im, rules.consensus)))
    if stop_tol is not None or stop_divergence is not None:
        record_residuals = True
    where = (device if mesh is None else
             f'{mesh.world} ranks ({mesh.backend}; this one on {device})')
    result = {'name': ('Fast ADMM-LSTM' if config.variant == 'fast'
                       else config.variant)}
    result.update(run_chunked(
        f'Training has started on {where}', state,
        lambda st: epoch_step(st, x_im, y_im, xall_im, vy_im, rules,
                              with_residuals=record_residuals),
        initial, config.epochs, start_epoch, log_every, checkpoint_every,
        ckpt_mgr, stop_tol, stop_divergence, record_residuals, track_best))
    if mesh is not None:
        from admm_lstm_torch.parallel.sharding import gather_state
        result['state'] = gather_state(result['state'], mesh)
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


def _probe_length(config: ADMMConfig, probe_epochs: int) -> int:
    """The presets' probe budget: a quarter of the run's, at least
    `probe_epochs`, at most the run's."""
    return max(1, min(config.epochs, max(probe_epochs, config.epochs // 4)))


def _probe_and_commit(label: str, names, n_probe: int, probe, commit):
    """The probe-and-commit loop of both models' presets: `probe(name)`
    runs each named candidate for the probe budget, ranked by its
    validation trajectory's nan-min (a non-finite one as inf), and
    `commit(winner)` runs the winner for the full budget.  Returns the
    committed run's result with 'preset_choice' and 'probe_val'."""
    probe_val: Dict[str, float] = {}
    for name in names:
        v = float(np.nanmin(np.asarray(probe(name)['val_loss'])))
        probe_val[name] = v if np.isfinite(v) else float('inf')
    winner = min(probe_val, key=probe_val.get)
    info(f"preset='best'{label}: probe {n_probe} epochs -> "
         + ', '.join(f'{k} {v:.6g}' for k, v in probe_val.items())
         + f'; committing to {winner}.')
    result = commit(winner)
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
    candidates = {'shipped': (config, parameter_set),
                  'auto': (derive_auto_config(config), parameter_set)}
    n_probe = _probe_length(config, probe_epochs)
    if search_rounds:
        from admm_lstm_torch.tune import refine_rho
        tuned = refine_rho(train_x, train_y, val_x, val_y, parameter_set,
                           config=config, epochs=n_probe,
                           rounds=search_rounds, params=params,
                           device=device)
        candidates['tuned'] = (config, tuned['best_parameter_set'])

    def run(name, epochs, log_every, **kw):
        cand, pset = candidates[name]
        return train(train_x, train_y, val_x, val_y, pset,
                     config=cand.replace(epochs=epochs), params=params,
                     log_every=log_every, track_best=True,
                     stop_divergence=divergence_guard, device=device, **kw)

    return _probe_and_commit(
        '', candidates, n_probe, lambda name: run(name, n_probe, 0),
        lambda name: run(name, config.epochs, log_every, **train_kw))


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
    from admm_lstm_torch.variants.stacked import train_stacked
    device = resolve_device(device)
    if isinstance(parameter_set, dict):
        parameter_set = ParameterSet.from_dict(parameter_set)
    if params is not None:
        hiddens = tuple(lp.hidden_size for lp in params.layers)
    hiddens = tuple(hiddens or (config.hidden_size,) * 2)
    n_probe = _probe_length(config, probe_epochs)

    candidates = {'shipped': parameter_set}
    if search_rounds:
        from admm_lstm_torch.tune import refine_rho_stacked
        n_rounds = max(search_rounds, 2) if n_probe >= 100 else search_rounds
        tuned = refine_rho_stacked(train_x, train_y, val_x, val_y,
                                   parameter_set, hiddens, config=config,
                                   epochs=n_probe, rounds=n_rounds,
                                   params=params, device=device)
        candidates['tuned'] = tuned['best_parameter_set']

    def run(name, epochs, log_every):
        return train_stacked(train_x, train_y, val_x, val_y,
                             candidates[name], config.replace(epochs=epochs),
                             log_every=log_every, hiddens=hiddens,
                             params=params, device=device)

    result = _probe_and_commit(
        f' [stacked {hiddens}]', candidates, n_probe,
        lambda name: run(name, n_probe, 0),
        lambda name: run(name, config.epochs, log_every))
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
    xs, ys, vxs, vys = (as_tensor(a, device) for a in (xs, ys, vxs, vys))
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
    with matmul_precision(config.matmul_precision), span('train'):
        return _train(train_x, train_y, val_x, val_y, parameter_set, config,
                      rules, params, log_every, record_residuals,
                      checkpoint_dir, checkpoint_every, resume_from,
                      async_checkpoint, stop_tol, stop_divergence,
                      track_best, mesh.device, mesh)
