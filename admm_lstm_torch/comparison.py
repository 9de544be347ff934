"""Multi-optimizer comparison harness.

Counterpart of `admm_lstm_tpu/comparison.py` (reference:
comparison_experiment/comparison.py): run Fast ADMM-LSTM, ADMM-LSTM-L,
ADMM-LSTM-S (fresh or from a recorded trajectory) and the SGD, Adam and
Adagrad baselines on the same data, model and seed, overlay the train and
validation loss curves (symlog), and optionally export every validation
curve to a MATLAB .mat file.

Run: python -m admm_lstm_torch.comparison [--cpu] [-d GoogleStock] [-e 100]
     [--hidden 10] [--comp_sgd LR] [--comp_adam LR] [--comp_adagrad LR]
     [--comp_skip_fast] [--comp_admm_s_cache PATH] [--record_matlab_data]
     [--save] [--no-plot]

It runs on the CUDA card unless --cpu is given.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, Optional

import numpy as np

from admm_lstm_torch.models.lstm import LSTMParams
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.logging import ADMMError, error, info

with_admm_s = False   # reference: comparison.py:33 (off by default there too)
with_admm_l = True    # reference: comparison.py:34


def run_comparison(num_epochs: int, hidden_size: int, train_x, train_y,
                   test_x, test_y, parameter_set, seed: int = 0,
                   lrs: Dict[str, float] | None = None,
                   skip_fast: bool = False, include_admm_l: bool = True,
                   include_admm_s: bool = False,
                   admm_s_cached: Dict | str | None = None,
                   save: bool = False, params: Optional[LSTMParams] = None,
                   device='cuda') -> List[Dict]:
    """Run every optimizer on the same data on `device` ('cuda' by
    default; the CPU only when asked) and return their loss dicts, in the
    order Fast ADMM-LSTM, ADMM-LSTM-L, ADMM-LSTM-S, SGD, Adam, Adagrad.

    `params` are the initial weights of the Fast run and of the three
    baselines, each of which trains its own copy (default: `init_lstm_params`
    from `torch.Generator().manual_seed(seed)`; the JAX package draws from
    `jax.random`).  ADMM-LSTM-L and -S draw the reference's own init from
    `seed`."""
    import torch

    from admm_lstm_torch.api import train
    from admm_lstm_torch.models.lstm import init_lstm_params
    from admm_lstm_torch.utils.device import resolve_device
    from admm_lstm_torch.variants.grad_based import train_grad_based

    device = resolve_device(device)
    lrs = lrs or {}
    results: List[Dict] = []

    def fresh_params():
        if params is not None:
            return LSTMParams(*(w.detach().to(device).clone() for w in params))
        return init_lstm_params(torch.Generator().manual_seed(seed),
                                np.shape(train_x)[2], hidden_size,
                                np.shape(train_y)[1], device=device)

    if not skip_fast:
        cfg = ADMMConfig(epochs=num_epochs, hidden_size=hidden_size, seed=seed)
        results.append(train(train_x, train_y, test_x, test_y, parameter_set,
                             cfg, params=fresh_params(), log_every=0,
                             device=device))

    if include_admm_l:
        from admm_lstm_torch.variants.admm_l import admm_l_demo
        results.append(admm_l_demo(num_epochs, hidden_size, train_x, train_y,
                                   test_x, test_y, seed=seed, save=save,
                                   log_every=0, device=device))

    if include_admm_s:
        from admm_lstm_torch.variants.admm_s import admm_s_demo
        results.append(admm_s_demo(num_epochs, hidden_size, train_x, train_y,
                                   test_x, test_y, seed=seed, log_every=0,
                                   device=device))
    elif admm_s_cached is not None:
        # Recorded trajectories (the reference reads admm_s/results.py,
        # comparison.py:151-165).  A string is a path to either on-disk
        # format the reference trainer writes (ADMMLSTMS/main.py:344-359).
        if isinstance(admm_s_cached, str):
            from admm_lstm_torch.data.admm_s_cache import load_admm_s_cache
            admm_s_cached = load_admm_s_cache(admm_s_cached)
        cached = dict(admm_s_cached)
        cached['train_loss'] = cached['train_loss'][:num_epochs + 1]
        cached['val_loss'] = cached['val_loss'][:num_epochs + 1]
        results.append(cached)

    for method in ('sgd', 'adam', 'adagrad'):
        results.append(train_grad_based(
            method, train_x, train_y, test_x, test_y, num_epochs,
            params=fresh_params(), lr=lrs.get(method), device=device))

    return results


def export_matlab(loss_list: List[Dict], save_dir: str = 'MATLAB_VAL_DATA',
                  stem: str = 'MATLAB_Val_comparison') -> str:
    """Export the validation curves to .mat (comparison.py:199-210), one
    variable per method named without spaces and dashes."""
    import scipy.io as sio
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, stem + '.mat')
    sio.savemat(path, {
        re.sub('[ -]', '', m['name']): np.asarray(m['val_loss'])
        for m in loss_list})
    info(f'Validation loss has been saved to {path}.')
    return path


def main(argv=None) -> int:
    from admm_lstm_torch.cli import generate_parser, parse_num_samples
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.utils.device import NoCudaDeviceError, resolve_device
    from admm_lstm_torch.utils.plotting import plot_comparison
    try:
        args = generate_parser().parse_args(argv)
        try:
            device = resolve_device('cpu' if args.cpu else 'cuda')
        except NoCudaDeviceError as e:
            error(f'{e}.')
        (train_x, train_y, test_x, test_y), ps, title = load_dataset(
            args.dataset, parse_num_samples(args.num_train),
            parse_num_samples(args.num_val))
        seed = 0 if args.seed < 0 else args.seed
        info(f'Comparison on {title} ({device}), {args.epoch} epochs, '
             f'hidden size {args.hidden}.')
        results = run_comparison(
            args.epoch, args.hidden, train_x, train_y, test_x, test_y, ps,
            seed=seed,
            lrs={'sgd': args.comp_sgd, 'adam': args.comp_adam,
                 'adagrad': args.comp_adagrad},
            skip_fast=args.comp_skip_fast,
            include_admm_l=with_admm_l, include_admm_s=with_admm_s,
            admm_s_cached=args.comp_admm_s_cache,
            save=args.save, device=device)
        if args.plot:
            try:
                plot_comparison(results, args.epoch)
            except ImportError as e:
                error(str(e))
        if args.record_matlab_data:
            export_matlab(results)
        for m in results:
            info(f"{m['name']}: final train {m['train_loss'][-1]:.6f} | "
                 f"val {m['val_loss'][-1]:.6f}")
        return 0
    except ADMMError as e:
        return e.code


if __name__ == '__main__':
    sys.exit(main())
