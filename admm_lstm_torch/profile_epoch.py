"""Where an epoch's time goes on the card.

    python -m admm_lstm_torch.profile_epoch [--epochs 10] [--hidden H]
        [--config default|turbo|auto]
        [--data googlestock|yahoofinance|dna1|smsspam|gefcom2012wind|har]
        [--layers N [--hidden2 H2]]
        [--variant fast|admm_l|admm_s|sgd|adam|adagrad]
        [--candidates S [--scenarios]]

Trains on the CUDA card with the chosen configuration (the default
fast-ADMM run, ADMMConfig.turbo() or ADMMConfig.auto(); 3 warm-up epochs,
`--epochs` timed, then `--epochs` more under `torch.profiler`) on a
bundled dataset (H 10 unless --hidden says otherwise) or on the JAX bench's
HAR-shaped synthetic data (B 2048, T 10, I 561, O 6, ParameterSet 'HAR',
H 128, exact_solve_max_dim 1024), and
prints one JSON line: the wall ms per epoch (host clock, synchronized;
with and without the profiler), the device-busy ms per epoch (sum of CUDA
kernel and memcpy/memset times), the device's idle share of the profiled
wall time, the device operations per epoch, the host syncs per epoch
(`cudaStreamSynchronize` calls in the profiler's trace: a tensor read as
a Python number or bool, and a copy from pageable host memory such as
`torch.tensor(..., device='cuda')`, wait for the stream), the reads
(`aten::_local_scalar_dense`) and host-to-device copies
(`cudaMemcpyAsync`) among them, and the device ms per epoch of the ten
costliest kernels.  `--layers N` (N >= 2) profiles the stacked variant's epoch
instead (variants/stacked.py, ParameterSet 'Stacked', hiddens
[H] + [H2 or H] * (N - 1), the default config; --config and --data har
do not apply; with `--candidates S`, one batched stacked epoch of the
first S points of the 'Stacked' tuning's grid on the chosen data, as
`tune.search_rho_stacked` trains them: `--layers 2 --hidden 8
--candidates 27`).  `--variant admm_l|admm_s` profiles an ADMM-LSTM-L or -S
epoch (variants/admm_l.py, admm_s.py: the step and the two losses, from
the reference's seeded init, the default rules), `sgd|adam|adagrad` one
full-batch step of a gradient baseline at its default learning rate with
its two losses (variants/grad_based.py); --config, --layers and
--data har do not apply to them.  `--candidates S` profiles one epoch of
S candidates on the candidate axis (core/state.py) under the chosen
config: the first S points of `tune.candidate_grid` (repeated past its
27) on the chosen data, shared by the candidates, as `tune.search_rho`
trains them (GoogleStock's grid: `--candidates 27`, under auto():
`--candidates 27 --config auto`); with `--scenarios`, S
folds of YahooFinance with their own seed-split initial weights under
the CLI's `--scenarios` config (fast, `wy_lipschitz`), as
`api.train_scenarios` trains them.  Its line adds the per
candidate-epoch wall and busy ms.  It needs a CUDA card.
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
# --variant names besides the fast ADMM epoch.
LEGACY = ('admm_l', 'admm_s', 'sgd', 'adam', 'adagrad')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=10)
    parser.add_argument('--hidden', type=int, default=None)
    parser.add_argument('--config', default='default',
                        choices=['default', 'turbo', 'auto'])
    parser.add_argument('--data', default='googlestock',
                        choices=[*_DATASETS, 'har'])
    parser.add_argument('--layers', type=int, default=1)
    parser.add_argument('--hidden2', type=int, default=0)
    parser.add_argument('--variant', default='fast',
                        choices=['fast', *LEGACY])
    parser.add_argument('--candidates', type=int, default=0)
    parser.add_argument('--scenarios', action='store_true')
    args = parser.parse_args(argv)
    if args.candidates and args.variant != 'fast':
        parser.error('--candidates takes the fast variant')
    if args.scenarios and (not args.candidates or args.config != 'default'
                           or args.data == 'har'):
        parser.error('--scenarios needs --candidates S and takes the CLI\'s '
                     '--scenarios config (no --config, no --data har)')
    if args.layers >= 2 and (args.config != 'default' or args.data == 'har'
                             or args.scenarios):
        parser.error('--layers >= 2 takes the default config and a bundled '
                     'dataset (no --scenarios)')
    if args.variant != 'fast' and (args.config != 'default' or args.layers > 1
                                   or args.data == 'har'):
        parser.error('--variant admm_l|admm_s|sgd|adam|adagrad takes the '
                     'default config, one layer and a bundled dataset')
    if not torch.cuda.is_available():
        raise SystemExit('profile_epoch needs a CUDA card')

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
    if args.variant != 'fast':
        hiddens = [args.hidden]
        epoch, state = legacy_epoch(args.variant, args.hidden, f(tx), f(ty),
                                    f(vx), f(vy))
    elif args.layers >= 2:
        from admm_lstm_torch.variants import stacked
        hiddens = [args.hidden] + [args.hidden2 or args.hidden] * (
            args.layers - 1)
        ps = parameter_set('Stacked')
        state = stacked.init_stacked_state(
            stacked.init_stacked(torch.Generator().manual_seed(0),
                                 tx.shape[2], hiddens, ty.shape[1],
                                 device=dev), f(tx), ps, cfg)
        if args.candidates:
            state = rho_grid(state, ps, args.candidates,
                             stacked.broadcast_stacked_state)

        def epoch(state):
            state = stacked.stacked_admm_step_im(state, x_im, y_im, rules)
            stacked.stacked_train_val_mse_im(state.params, xall, y_im, vy_im)
            return state
    else:
        hiddens = [args.hidden]
        if args.scenarios:
            cfg, (x_im, y_im, xall, vy_im), state = scenario_batch(
                args.candidates, args.hidden, dev)
            rules = rules_for(cfg)
            set_matmul_precision(cfg.matmul_precision)
        else:
            params = init_lstm_params(torch.Generator().manual_seed(0),
                                      tx.shape[2], args.hidden, ty.shape[1],
                                      device=dev)
            state = init_admm_state(params, f(tx), ps, cfg)
            if args.candidates:
                state = rho_grid(state, ps, args.candidates)

        def epoch(state):
            return epoch_step(state, x_im, y_im, xall, vy_im, rules)[0]

    prof = profile_epochs(epoch, state, args.epochs)
    if args.candidates:
        for k in ('wall_ms_per_epoch', 'device_busy_ms_per_epoch'):
            prof[k.replace('_epoch', '_candidate_epoch')] = (
                prof[k] / args.candidates)
    print(json.dumps({
        'device': torch.cuda.get_device_name(0),
        'config': args.config, 'data': 'yahoofinance scenario folds'
        if args.scenarios else args.data, 'epochs': args.epochs,
        'hidden': args.hidden, 'hiddens': hiddens, 'variant': args.variant,
        'candidates': args.candidates, **prof}))
    return 0


def rho_grid(state, ps, count: int, broadcast=None):
    """`state` (without the candidate axis) broadcast over the first
    `count` points of `tune.candidate_grid(ps)`, repeated past its end, by
    `broadcast` (core/state.broadcast_state, or the stacked state's
    `variants/stacked.broadcast_stacked_state`)."""
    import numpy as np

    from admm_lstm_torch.core.state import (broadcast_state,
                                            penalties_from_vectors)
    from admm_lstm_torch.tune import candidate_grid
    grid = np.resize(candidate_grid(ps), (count, 7))
    return (broadcast or broadcast_state)(state, count, penalties_from_vectors(
        grid, device=state.params.wy.device))


def scenario_batch(count: int, hidden: int, dev):
    """(config, batch-minor inputs, state) of `count` YahooFinance folds
    under the CLI's --scenarios config, each with the initial weights
    `api.train_scenarios` draws for it."""
    from admm_lstm_torch.api import batch_minor, scenario_inits
    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.data.yahoo_finance import load_scenarios
    from admm_lstm_torch.params import parameter_set
    from admm_lstm_torch.utils.config import ADMMConfig
    cfg = ADMMConfig(hidden_size=hidden, wy_lipschitz=True)
    xs, ys, vxs, vys = (torch.from_numpy(a).to(dev) for a in
                        load_scenarios(num_scenarios=count, seed=0))
    params = scenario_inits(cfg.seed, count, xs.shape[3], hidden,
                            ys.shape[2], dev)
    state = init_admm_state(params, xs, parameter_set('YahooFinance'), cfg)
    return cfg, batch_minor(xs, ys, vxs, vys), state


def legacy_epoch(variant: str, hidden: int, tx, ty, vx, vy):
    """(epoch, state) for a legacy variant or gradient baseline on
    tensors (B, T, I), (B, O): `epoch(state)` runs one epoch with its two
    losses and returns the next state (None for the baselines, whose
    optimizer carries it)."""
    from admm_lstm_torch.models.lstm import init_lstm_params
    x_tm = tx.transpose(0, 1).contiguous()
    if variant == 'admm_l':
        from admm_lstm_torch.variants import admm_l
        rules = admm_l.ADMMLRules()
        state = admm_l.init_admm_l_state(*admm_l.init_weights_like_reference(
            0, tx.shape[2], hidden, ty.shape[1], device=tx.device), x_tm)
        return (lambda s: admm_l.epoch(s, x_tm, tx, ty, vx, vy, rules)[0],
                state)
    if variant == 'admm_s':
        from admm_lstm_torch.variants import admm_s
        rules = admm_s.ADMMSRules()
        vx_tm = vx.transpose(0, 1).contiguous()
        state = admm_s.init_admm_s_state(*admm_s.init_weights_like_reference(
            0, tx.shape[2], hidden, ty.shape[1], device=tx.device),
            batch=tx.shape[0])
        return (lambda s: admm_s.epoch(s, x_tm, ty, vx_tm, vy, rules)[0],
                state)
    from admm_lstm_torch.variants.grad_based import make_grad_epoch
    params = init_lstm_params(torch.Generator().manual_seed(0), tx.shape[2],
                              hidden, ty.shape[1], device=tx.device)
    _, step = make_grad_epoch(variant, params, tx, ty, vx, vy)

    def epoch(state):
        step()
        return state
    return epoch, None


def profile_epochs(epoch, state, epochs: int) -> dict:
    """3 warm-up epochs, `epochs` timed, `epochs` more under
    torch.profiler: the wall ms per epoch (host clock, synchronized; with
    and without the profiler), device-busy ms, idle share, device
    operations, host syncs, reads and host-to-device copies per epoch, and
    the ten costliest kernels' device ms per epoch."""

    def run(state, n):
        for _ in range(n):
            state = epoch(state)
        torch.cuda.synchronize()
        return state

    state = run(state, 3)
    t0 = time.perf_counter()
    state = run(state, epochs)
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / epochs
    prof = device_profile(lambda: run(state, epochs))
    per = {k: v / epochs for k, v in prof.items() if k != 'kernels_ms'}
    top = sorted(prof['kernels_ms'].items(), key=lambda kv: -kv[1])[:10]
    return {
        'wall_ms_per_epoch': plain_wall_ms,
        'wall_ms_per_epoch_profiled': per['wall_ms'],
        'device_busy_ms_per_epoch': per['busy_ms'],
        'device_idle_share': max(0.0, 1.0 - per['busy_ms'] / per['wall_ms']),
        'device_ops_per_epoch': per['device_ops'],
        'host_syncs_per_epoch': per['host_syncs'],
        'reads_per_epoch': per['reads'],
        'memcpy_calls_per_epoch': per['memcpy_calls'],
        'top_kernels_ms_per_epoch': {k: v / epochs for k, v in top},
    }


def device_profile(fn) -> dict:
    """Runs `fn` (work that ends in a synchronize) once under
    torch.profiler: its wall ms (host clock), device-busy ms (CUDA
    kernels, memcpy and memset), device operations, host syncs
    (`cudaStreamSynchronize`), reads (`aten::_local_scalar_dense`),
    host-to-device copy calls (`cudaMemcpyAsync`) and each kernel's
    device ms ('kernels_ms')."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    busy_us, launches = 0.0, 0
    host = {'cudaStreamSynchronize': 0, 'aten::_local_scalar_dense': 0,
            'cudaMemcpyAsync': 0}
    for evt in prof.events():
        if getattr(evt, 'is_user_annotation', False):
            continue      # a range such as Optimizer.step, not device work
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            if evt.name in host:
                host[evt.name] += 1
            continue
        dur = evt.time_range.elapsed_us()
        busy_us += dur
        launches += 1
        name = evt.name[:100]
        kernels[name] = kernels.get(name, 0.0) + dur / 1e3
    return {'wall_ms': wall_ms, 'busy_ms': busy_us / 1e3,
            'device_ops': launches,
            'host_syncs': host['cudaStreamSynchronize'],
            'reads': host['aten::_local_scalar_dense'],
            'memcpy_calls': host['cudaMemcpyAsync'], 'kernels_ms': kernels}


if __name__ == '__main__':
    raise SystemExit(main())
