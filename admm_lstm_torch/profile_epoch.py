"""Where an epoch's time goes on the card.

    python -m admm_lstm_torch.profile_epoch [--epochs 10] [--hidden H]
        [--config default|turbo|auto]
        [--data googlestock|yahoofinance|dna1|smsspam|gefcom2012wind|har]

Trains on the CUDA card with the chosen configuration (the default
fast-ADMM run, ADMMConfig.turbo() or ADMMConfig.auto(); 3 warm-up epochs,
`--epochs` timed, then `--epochs` more under `torch.profiler`) on a
bundled dataset (H 10 unless --hidden says otherwise) or on the JAX bench's
HAR-shaped synthetic data (B 2048, T 10, I 561, O 6, ParameterSet 'HAR',
H 128, exact_solve_max_dim 1024), and
prints one JSON line: the wall ms per epoch (host clock, synchronized;
with and without the profiler), the device-busy ms per epoch (sum of CUDA
kernel and memcpy/memset times), the device's idle share of the profiled
wall time, the device operations per epoch, and the device ms per epoch
of the ten costliest kernels.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# --data names of the bundled datasets.
_DATASETS = {'googlestock': 'GoogleStock', 'yahoofinance': 'YahooFinance',
             'dna1': 'DNA1', 'smsspam': 'SMSSpam',
             'gefcom2012wind': 'GEFCOM2012Wind'}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=10)
    parser.add_argument('--hidden', type=int, default=None)
    parser.add_argument('--config', default='default',
                        choices=['default', 'turbo', 'auto'])
    parser.add_argument('--data', default='googlestock',
                        choices=[*_DATASETS, 'har'])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_epoch needs a CUDA card')

    from torch.profiler import ProfilerActivity, profile

    from admm_lstm_torch.api import batch_minor
    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.core.step import epoch_step, rules_for
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.data.synthetic import load as synth_load
    from admm_lstm_torch.models.lstm import init_lstm_params
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    from admm_lstm_torch.utils.device import set_matmul_precision

    make = {'default': ADMMConfig, 'turbo': ADMMConfig.turbo,
            'auto': ADMMConfig.auto}[args.config]
    if args.data == 'har':
        args.hidden = args.hidden or 128
        cfg = make(hidden_size=args.hidden, exact_solve_max_dim=1024)
        tx, ty, vx, vy = synth_load(batch=2048, seq_len=10, input_size=561,
                                    output_size=6, val_batch=128)
        ps = parameter_set('HAR')
    else:
        args.hidden = args.hidden or 10
        cfg = make(hidden_size=args.hidden)
        (tx, ty, vx, vy), ps, _ = load_dataset(_DATASETS[args.data])
    set_matmul_precision(cfg.matmul_precision)
    rules = rules_for(cfg)
    dev = torch.device('cuda')
    f = lambda a: torch.from_numpy(a).to(dev)
    x_im, y_im, xall, vy_im = batch_minor(f(tx), f(ty), f(vx), f(vy))
    params = init_lstm_params(torch.Generator().manual_seed(0), tx.shape[2],
                              args.hidden, ty.shape[1], device=dev)
    state = init_admm_state(params, f(tx), ps, cfg)

    def run(state, n):
        for _ in range(n):
            state, _ = epoch_step(state, x_im, y_im, xall, vy_im, rules)
        torch.cuda.synchronize()
        return state

    state = run(state, 3)
    t0 = time.perf_counter()
    state = run(state, args.epochs)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / args.epochs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        state = run(state, args.epochs)
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.epochs

    kernels = {}
    busy_us, launches = 0.0, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = evt.time_range.elapsed_us()
        busy_us += dur
        launches += 1
        name = evt.name[:100]
        kernels[name] = kernels.get(name, 0.0) + dur
    busy_ms = busy_us / 1e3 / args.epochs
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        'device': torch.cuda.get_device_name(0),
        'config': args.config, 'data': args.data, 'epochs': args.epochs,
        'hidden': args.hidden,
        'wall_ms_per_epoch': plain_wall_ms,
        'wall_ms_per_epoch_profiled': wall_ms,
        'device_busy_ms_per_epoch': busy_ms,
        'device_idle_share': max(0.0, 1.0 - busy_ms / wall_ms),
        'device_ops_per_epoch': launches / args.epochs,
        'top_kernels_ms_per_epoch': {k: v / 1e3 / args.epochs
                                     for k, v in top},
    }))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
