"""Training demo CLI: the reference's `python demo.py` counterpart.

Usage: python -m admm_lstm_torch.cli [-d GoogleStock] [-e 100] [--hidden 10] ...

Runs on the CUDA card unless --cpu is given; with neither a card nor
--cpu it exits non-zero.  `--scenarios S` trains the YahooFinance scenario
batch (api.train_scenarios); `--save` writes the final weights under
SAVED_MODELS/ and `--record_matlab_data` the validation curve to
ADMM_Val.mat, both in the working directory.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from admm_lstm_torch import __version__
from admm_lstm_torch.params import default_epoch
from admm_lstm_torch.utils.config import AUTO_FIELDS, ADMMConfig
from admm_lstm_torch.utils.device import NoCudaDeviceError, resolve_device
from admm_lstm_torch.utils.logging import ADMMError, error, info, log_assert


def generate_parser() -> argparse.ArgumentParser:
    from admm_lstm_torch.data import supported_datasets
    parser = argparse.ArgumentParser(prog='admm-lstm-torch')
    parser.add_argument('--data_dir', default=None, type=str,
                        help='Directory holding the raw files of the '
                             'selected dataset (HAR: X/y_{train,test}.txt; '
                             'GEFCOM2012: Load/Load_history.csv)')
    parser.add_argument('--dataset', '-d', default='GoogleStock', type=str,
                        help=f'Supported datasets: {supported_datasets}')
    parser.add_argument('--epoch', '-e', default=default_epoch, type=int,
                        help='Number of epochs')
    parser.add_argument('--num_train', '-nt', default='all', type=str,
                        help="Number of training samples or 'all'")
    parser.add_argument('--num_val', '-nv', default='all', type=str,
                        help="Number of validation samples or 'all'")
    parser.add_argument('--hidden', default=10, type=int,
                        help='Number of hidden neurons in the LSTM')
    parser.add_argument('--layers', default=1, type=int,
                        help='LSTM depth: >= 2 trains the stacked ADMM '
                             'variant')
    parser.add_argument('--hidden2', default=0, type=int,
                        help='Width of layers above the first '
                             '(default: same as --hidden)')
    parser.add_argument('--version', '-v', action='version',
                        version=f'%(prog)s {__version__}')
    parser.add_argument('--seed', '-s', default=-1, type=int,
                        help='Seed (-1 uses the default seed 0)')
    parser.add_argument('--yes', '-y', action='store_true',
                        help='Skip interactive confirmation')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU (the default is the CUDA card)')
    parser.add_argument('--save', action='store_true',
                        help='Save the final model under SAVED_MODELS/')
    parser.add_argument('--variant', default='fast',
                        choices=['fast', 'no_dual_y', 'admm_l', 'admm_s'],
                        help='ADMM solver variant')
    parser.add_argument('--with_dual_y', action='store_true',
                        help='Enable the output dual (admm.py:12 flag)')
    parser.add_argument('--dtype', default='float32',
                        choices=['float32', 'bfloat16'],
                        help='Storage dtype of the gate/dual slabs '
                             '(math always runs in f32)')
    parser.add_argument('--residuals', action='store_true',
                        help='Log ADMM primal+dual residuals each epoch')
    parser.add_argument('--adaptive_rho', action='store_true',
                        help='Residual-balancing rho adaptation (implies '
                             'the Lipschitz-safeguarded wy step)')
    parser.add_argument('--adapt_stop_epoch', default=0, type=int,
                        help='Freeze the rho adaptation after this epoch '
                             '(0 = adapt forever)')
    parser.add_argument('--stop_tol', default=None, type=float,
                        help='Stop once every ADMM primal+dual residual '
                             'is below this tolerance')
    parser.add_argument('--stop_divergence', default=None, type=float,
                        help='Divergence guard: stop once the max ADMM '
                             'residual grows past this factor of its '
                             'running minimum')
    parser.add_argument('--track_best', action='store_true',
                        help='Return the best-validation iterate instead '
                             'of the final one (tracked on device)')
    parser.add_argument('--exact_weight_solve', action='store_true',
                        help='Exact Gauss-Newton weight solve (batched '
                             'Cholesky) instead of the prox-linear step')
    parser.add_argument('--turbo', action='store_true',
                        help='The speed preset (ADMMConfig.turbo): Jacobi '
                             'sweep + exact weight solve + TF32 matmuls')
    parser.add_argument('--auto', action='store_true',
                        help='--turbo plus residual-balancing rho with a '
                             '10-epoch warmup (ADMMConfig.auto)')
    parser.add_argument('--preset', default=None, choices=['best'],
                        help="'best': probe the shipped tuning and the "
                             'auto() composition, commit to the better '
                             '(api.train_best)')
    parser.add_argument('--checkpoint_dir', default=None, type=str,
                        help='Directory of full-state checkpoints')
    parser.add_argument('--checkpoint_every', default=0, type=int,
                        help='Save a checkpoint every this many epochs')
    parser.add_argument('--resume', action='store_true',
                        help='Resume from the latest checkpoint in '
                             '--checkpoint_dir (full optimizer state)')
    parser.add_argument('--tune_rho', default=0, type=int, metavar='ROUNDS',
                        help='Run ROUNDS of successive-halving rho '
                             'refinement before training and use the '
                             'winner (each round\'s candidates as one '
                             'batched program, tune.refine_rho)')
    parser.add_argument('--mesh', default=0, type=int,
                        help='Data-parallel training over this many ranks, '
                             'one process each (0 = one process); NCCL '
                             'when each rank has a card of its own, else '
                             'gloo')
    parser.add_argument('--scenarios', default=0, type=int, metavar='S',
                        help='Train S independent scenario batches in one '
                             'batched program (YahooFinance multi-ticker '
                             'config, api.train_scenarios)')
    parser.add_argument('--record_matlab_data', action='store_true',
                        help='Export validation losses as a .mat file')
    parser.add_argument('--plot', action='store_true', default=True)
    parser.add_argument('--no-plot', dest='plot', action='store_false')
    # The comparison harness's knobs (python -m admm_lstm_torch.comparison).
    parser.add_argument('--comp_sgd', default=1.5, type=float)
    parser.add_argument('--comp_adam', default=.2, type=float)
    parser.add_argument('--comp_adagrad', default=1.0, type=float)
    parser.add_argument('--comp_skip_fast', action='store_true', default=False)
    parser.add_argument('--comp_admm_s_cache', default=None, type=str,
                        help='Path to a recorded ADMM-LSTM-S trajectory in '
                             'either reference format (admm_s/results.py or '
                             'ADMM-LSTM.<dataset>) to overlay')
    return parser


def parse_num_samples(value: str) -> Optional[int]:
    if value in ('all', "'all'"):
        return None
    try:
        n = int(value)
    except ValueError:
        error("Usage: --num_train all | --num_train <positive int>")
    log_assert(n > 0, "The number of samples must be a positive integer or 'all'.")
    return n


def _train_stacked(args, seed, train_x, train_y, val_x, val_y, device):
    """--layers >= 2 (the JAX CLI's stacked branch): the stacked variant
    with the 'Stacked' tuning and the variant's plain config, hiddens
    [hidden] + [hidden2 or hidden] * (layers - 1); --preset best runs
    api.train_best_stacked.  Returns (parameter set, result)."""
    from admm_lstm_torch.params import parameter_set
    ps = parameter_set('Stacked')
    cfg = ADMMConfig(variant=args.variant, with_dual_y=args.with_dual_y,
                     epochs=args.epoch, hidden_size=args.hidden, seed=seed)
    hiddens = [args.hidden] + [args.hidden2 or args.hidden] * (args.layers - 1)
    if args.preset:
        from admm_lstm_torch.api import train_best_stacked
        return ps, train_best_stacked(train_x, train_y, val_x, val_y, ps, cfg,
                                      hiddens=hiddens, device=device)
    from admm_lstm_torch.variants.stacked import train_stacked
    return ps, train_stacked(train_x, train_y, val_x, val_y, ps, cfg,
                             hiddens=hiddens, log_every=1, device=device)


def _train_legacy(args, seed, train_x, train_y, val_x, val_y, ps, device):
    """--variant admm_l|admm_s (the JAX CLI's legacy branch): the
    variant's demo run, or api.train_best's probe-and-commit over its own
    rule constants with --preset best."""
    if args.preset:
        from admm_lstm_torch.api import train_best
        cfg = ADMMConfig(variant=args.variant, epochs=args.epoch,
                         hidden_size=args.hidden, seed=seed)
        return train_best(train_x, train_y, val_x, val_y, ps, config=cfg,
                          device=device)
    if args.variant == 'admm_l':
        from admm_lstm_torch.variants.admm_l import admm_l_demo
        return admm_l_demo(args.epoch, args.hidden, train_x, train_y, val_x,
                           val_y, seed=seed, device=device)
    from admm_lstm_torch.variants.admm_s import admm_s_demo
    return admm_s_demo(args.epoch, args.hidden, train_x, train_y, val_x,
                       val_y, seed=seed, device=device)


def _scenario_conflict(args) -> Optional[str]:
    """The flag that --scenarios does not take, or None.  The JAX CLI's
    scenario branch ignores these; the port refuses them."""
    for given, flag in ((args.mesh, '--mesh'),
                        (args.layers >= 2, '--layers >= 2'),
                        (args.preset, '--preset'),
                        (args.tune_rho, '--tune_rho'),
                        (args.checkpoint_dir, '--checkpoint_dir'),
                        (args.resume, '--resume'),
                        (args.variant in ('admm_l', 'admm_s'),
                         f'--variant {args.variant}')):
        if given:
            return flag
    return None


def _train_scenarios(args, seed, ps, device):
    """--scenarios S (the JAX CLI's scenario branch): S disjoint folds of
    the YahooFinance windows through api.train_scenarios with the
    Lipschitz-safeguarded readout step; the result's train and validation
    curves are the means over the scenarios."""
    from admm_lstm_torch.api import train_scenarios
    from admm_lstm_torch.data.yahoo_finance import load_scenarios
    xs, ys, vxs, vys = load_scenarios(num_scenarios=args.scenarios, seed=seed)
    cfg = ADMMConfig(variant=args.variant, with_dual_y=args.with_dual_y,
                     epochs=args.epoch, hidden_size=args.hidden, seed=seed,
                     wy_lipschitz=True)
    results = train_scenarios(xs, ys, vxs, vys, ps, cfg, device=device)
    return dict(results, train_loss=list(results['train_loss'].mean(0)),
                val_loss=list(results['val_loss'].mean(0)))


def _save(args, results) -> None:
    """--save: the result's weights through ckpt.save_model, one file per
    scenario under --scenarios; a result without weights (ADMM-S) saves
    nothing, as in the JAX CLI."""
    if 'params' not in results:
        return
    from admm_lstm_torch.ckpt import save_model
    from admm_lstm_torch.models.lstm import LSTMParams
    if args.scenarios:
        for i in range(args.scenarios):
            save_model(f"{results['name']} scenario {i}",
                       LSTMParams(*(w[i] for w in results['params'])))
    else:
        save_model(results['name'], results['params'])


def _mesh_backend(ranks: int, device) -> str:
    """--mesh's backend (parallel.mesh.backend_for): NCCL when each rank
    has a card of its own; gloo on the CPU and where ranks share a card,
    which NCCL refuses.  Said in the log."""
    from admm_lstm_torch.parallel.mesh import backend_for
    if device.type != 'cuda':
        info(f'--mesh {ranks}: backend gloo, {ranks} ranks on the CPU.')
        return backend_for(device, ranks)
    cards = torch.cuda.device_count()
    backend = backend_for(device, ranks, 'gloo' if ranks > cards else None)
    info(f'--mesh {ranks}: backend {backend}, {ranks} ranks on '
         f'{min(ranks, cards)} card(s), up to {-(-ranks // cards)} ranks '
         f'sharing a card.')
    return backend


def main(argv=None) -> int:
    from admm_lstm_torch.data import load_dataset, supported_datasets
    args = generate_parser().parse_args(argv)
    try:
        if args.scenarios:
            conflict = _scenario_conflict(args)
            if conflict:
                error(f'--scenarios trains the one-layer fast/no_dual_y '
                      f'scenario batch; drop {conflict}')
            if args.dataset != 'YahooFinance':
                error('--scenarios currently builds scenario batches from '
                      'the YahooFinance windows; use -d YahooFinance')
        if args.layers >= 2 and args.variant not in ('fast', 'no_dual_y'):
            error('--layers >= 2 supports the fast/no_dual_y variants only')
        if args.mesh:
            if args.preset:
                error('--preset is a single-device loop feature '
                      '(probe-and-commit); drop --mesh or --preset')
            if args.layers >= 2 or args.variant in ('admm_l', 'admm_s'):
                error('--mesh trains the one-layer fast/no_dual_y variants '
                      'only')
        try:
            device = resolve_device('cpu' if args.cpu else 'cuda')
        except NoCudaDeviceError as e:
            error(f'{e}.')
        name = (f' ({torch.cuda.get_device_name(device)})'
                if device.type == 'cuda' else '')
        info(f'Program is running on {device}{name}.')
        log_assert(args.dataset in supported_datasets,
                   f'Dataset {args.dataset} is not supported by '
                   f'admm_lstm_torch; choose from {supported_datasets}.')
        num_train = parse_num_samples(args.num_train)
        num_val = parse_num_samples(args.num_val)
        log_assert(args.epoch > 0,
                   'The number of epochs must be a positive integer.')
        loader_kwargs = {}
        if args.data_dir:
            log_assert(args.dataset in ('HAR', 'GEFCOM2012'),
                       '--data_dir applies to the raw-file datasets '
                       '(HAR, GEFCOM2012)')
            loader_kwargs['path'] = args.data_dir
        if args.resume and not args.checkpoint_dir:
            error('--resume requires --checkpoint_dir')
        (train_x, train_y, val_x, val_y), ps, title = load_dataset(
            args.dataset, num_train, num_val, **loader_kwargs)
        seed = 0 if args.seed < 0 else args.seed

        info(f'Training summary: \n'
             f'  - Dataset: {title}.\n'
             f'  - Number of epochs: {args.epoch}.\n'
             f'  - Training samples: {train_x.shape[0]} '
             f'(Shape: {list(train_x.shape)}, {list(train_y.shape)}).\n'
             f'  - Validation samples: {val_x.shape[0]} '
             f'(Shape: {list(val_x.shape)}, {list(val_y.shape)}).\n'
             f'  - Hidden size: {args.hidden}.\n'
             f'  - Variant: {args.variant} (dual_y: {args.with_dual_y}).\n'
             f'  - Constants: beta {ps.beta}\n'
             f'               rho {ps.rho}')

        if not args.yes and sys.stdin.isatty():
            command = input("Input 'c' or 'q' to abort, any other key to continue: ")
            if command in ('c', 'q'):
                info('Training aborted. Process has terminated.')
                return 0

        from admm_lstm_torch.api import train
        if args.scenarios:
            results = _train_scenarios(args, seed, ps, device)
        elif args.layers >= 2:
            ps, results = _train_stacked(args, seed, train_x, train_y, val_x,
                                         val_y, device)
        elif args.variant in ('admm_l', 'admm_s'):
            results = _train_legacy(args, seed, train_x, train_y, val_x,
                                    val_y, ps, device)
        else:
            cfg = ADMMConfig(variant=args.variant,
                             with_dual_y=args.with_dual_y,
                             epochs=args.epoch, hidden_size=args.hidden,
                             seed=seed, adaptive_rho=args.adaptive_rho,
                             adapt_stop_epoch=args.adapt_stop_epoch,
                             exact_weight_solve=args.exact_weight_solve,
                             dtype=args.dtype)
            # The JAX CLI's compositions: --auto is ADMMConfig.auto() (an
            # explicit --adapt_stop_epoch wins), --turbo ADMMConfig.turbo().
            if args.auto:
                cfg = cfg.replace(**dict(
                    AUTO_FIELDS, adapt_stop_epoch=(
                        args.adapt_stop_epoch
                        or AUTO_FIELDS['adapt_stop_epoch'])))
            elif args.turbo:
                cfg = cfg.replace(sweep_mode='jacobi', exact_weight_solve=True,
                                  matmul_precision='default')
            if args.tune_rho:
                from admm_lstm_torch.tune import refine_rho
                tuned = refine_rho(train_x, train_y, val_x, val_y, ps,
                                   config=cfg, epochs=min(30, args.epoch),
                                   rounds=args.tune_rho, device=device)
                ps = tuned['best_parameter_set']
                info(f'rho search ({args.tune_rho} rounds of '
                     f'{len(tuned["candidates"])} candidates, each round '
                     f'one batched program): best val '
                     f'{tuned["best_val_loss"]:.8f} with rho {ps.rho}')
            kw = dict(record_residuals=args.residuals,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      resume_from=(args.checkpoint_dir if args.resume
                                   else None),
                      stop_tol=args.stop_tol,
                      stop_divergence=args.stop_divergence,
                      track_best=args.track_best, device=device)
            if args.mesh:
                from admm_lstm_torch.api import train_sharded
                results = train_sharded(
                    train_x, train_y, val_x, val_y, ps,
                    cfg.replace(mesh_shape=(args.mesh,)),
                    backend=_mesh_backend(args.mesh, device), **kw)
            else:
                results = train(train_x, train_y, val_x, val_y, ps, cfg,
                                preset=args.preset, **kw)
        if args.residuals:
            for epoch, res in enumerate(results.get('residuals', ()),
                                        start=1):
                info(f'Epoch {epoch} residuals: '
                     + ' '.join(f'{k} {v:.3e}' for k, v in res.items()))

        if args.plot:
            from admm_lstm_torch.utils.plotting import LossCurvePlotter
            for split, name in (('train_loss', 'ADMMTrainingLoss'),
                                ('val_loss', 'ADMMValidationLoss')):
                plotter = LossCurvePlotter(
                    title=name, save_dir='plots',
                    constant_dicts=(ps.beta, ps.rho))
                for e, loss in enumerate(results[split]):
                    plotter.update(e, loss)
                try:
                    plotter.plot(save_name=name)
                except ImportError as e:
                    error(str(e))

        if args.record_matlab_data:
            import scipy.io as sio
            sio.savemat('ADMM_Val.mat', {
                'epoch': np.arange(len(results['val_loss'])),
                'loss': np.asarray(results['val_loss']),
            })
            info('Validation losses exported to ADMM_Val.mat')
        if args.save:
            _save(args, results)
        return 0
    except ADMMError as e:
        return e.code
    except KeyboardInterrupt:
        info('Training aborted by user. Process has terminated.')
        return 0


if __name__ == '__main__':
    sys.exit(main())
