"""Where a GoogleStock epoch's time goes on the card.

    python -m admm_lstm_torch.profile_epoch [--epochs 10] [--hidden 10]

Trains the default fast-ADMM GoogleStock run on the CUDA card (3 warm-up
epochs, `--epochs` timed, then `--epochs` more under `torch.profiler`) and
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--epochs', type=int, default=10)
    parser.add_argument('--hidden', type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_epoch needs a CUDA card')

    from torch.profiler import ProfilerActivity, profile

    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.core.step import epoch_step, rules_for
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.models.lstm import init_lstm_params
    from admm_lstm_torch.utils.config import ADMMConfig
    from admm_lstm_torch.utils.device import set_matmul_precision

    cfg = ADMMConfig(hidden_size=args.hidden)
    set_matmul_precision(cfg.matmul_precision)
    rules = rules_for(cfg)
    dev = torch.device('cuda')
    (tx, ty, vx, vy), ps, _ = load_dataset('GoogleStock')
    f = lambda a: torch.from_numpy(a).to(dev)
    x_im = f(tx).permute(1, 2, 0).contiguous()
    y_im, vy_im = f(ty).T.contiguous(), f(vy).T.contiguous()
    xall = torch.cat([x_im, f(vx).permute(1, 2, 0)], dim=-1).contiguous()
    params = init_lstm_params(torch.Generator().manual_seed(0), 1,
                              args.hidden, 1, device=dev)
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
        'epochs': args.epochs, 'hidden': args.hidden,
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
