"""Training demo CLI: the reference's `python demo.py` counterpart.

Usage: python -m admm_lstm_torch.cli [-d GoogleStock] [-e 100] [--hidden 10] ...

Runs on the CUDA card unless --cpu is given; with neither a card nor
--cpu it exits non-zero.  Flags of paths not ported yet are accepted by
the parser so that they fail with a clear message instead of "unknown
argument".
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from admm_lstm_torch import __version__
from admm_lstm_torch.params import default_epoch
from admm_lstm_torch.utils.config import AUTO_FIELDS, LATER, ADMMConfig
from admm_lstm_torch.utils.device import NoCudaDeviceError, resolve_device
from admm_lstm_torch.utils.logging import ADMMError, error, info, log_assert

# Flags of the JAX CLI whose paths arrive in later slices of the port.
_LATER_FLAGS = ('mesh', 'layers', 'scenarios', 'save', 'record_matlab_data')


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
    parser.add_argument('--version', '-v', action='version',
                        version=f'%(prog)s {__version__}')
    parser.add_argument('--seed', '-s', default=-1, type=int,
                        help='Seed (-1 uses the default seed 0)')
    parser.add_argument('--yes', '-y', action='store_true',
                        help='Skip interactive confirmation')
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU (the default is the CUDA card)')
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
                             'refinement before training and use the winner')
    parser.add_argument('--plot', action='store_true', default=True)
    parser.add_argument('--no-plot', dest='plot', action='store_false')
    later = parser.add_argument_group('not ported yet (exit non-zero)')
    for flag in ('save', 'record_matlab_data'):
        later.add_argument(f'--{flag}', action='store_true',
                           help=argparse.SUPPRESS)
    for flag in ('mesh', 'layers', 'scenarios'):
        later.add_argument(f'--{flag}', default=None, type=int,
                           help=argparse.SUPPRESS)
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


def main(argv=None) -> int:
    from admm_lstm_torch.data import load_dataset, supported_datasets
    args = generate_parser().parse_args(argv)
    try:
        for flag in _LATER_FLAGS:
            if getattr(args, flag) not in (None, False):
                error(f'--{flag} is not ported to admm_lstm_torch yet; it '
                      f'arrives in {LATER}.')
        if args.variant in ('admm_l', 'admm_s'):
            error(f'--variant {args.variant} is not ported to admm_lstm_torch '
                  f'yet; it arrives in {LATER}.')
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
        cfg = ADMMConfig(variant=args.variant, with_dual_y=args.with_dual_y,
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
            info(f'rho search ({args.tune_rho} rounds): best val '
                 f'{tuned["best_val_loss"]:.8f} with rho {ps.rho}')
        results = train(train_x, train_y, val_x, val_y, ps, cfg,
                        record_residuals=args.residuals,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every,
                        resume_from=(args.checkpoint_dir if args.resume
                                     else None),
                        stop_tol=args.stop_tol,
                        stop_divergence=args.stop_divergence,
                        track_best=args.track_best, preset=args.preset,
                        device=device)
        if args.residuals:
            for epoch, res in enumerate(results['residuals'], start=1):
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
        return 0
    except ADMMError as e:
        return e.code
    except KeyboardInterrupt:
        info('Training aborted by user. Process has terminated.')
        return 0


if __name__ == '__main__':
    sys.exit(main())
