"""The serial floor of the Gauss-Seidel sweep: the bare LSTM recurrence,
timed.

    python -m admm_lstm_torch.gs_floor [--seq 2048] [--hidden 16]
        [--batch 64] [--cpu]

The counterpart of `benchmarks/bench_gs_floor.py`.  `floor_sweep`
(`kernels/gate_sweep.py`, csrc/gate_sweep.cu) runs the recurrence that
a Gauss-Seidel step carries, with only the LSTM cell as its math: 4
loads and 1 store an element and step where the sweep has 14 and 11.  Up
to 32 hidden units it runs on a kernel written for the recurrence (the
carry passed between a warp's lanes by shuffles, no block barrier), so
its time a step prices the bare recurrence, and a Gauss-Seidel step's
distance from it is what the sweep's own structure costs; above 32, on
`interior_sweep`'s tile plan.

Inputs as the JAX probe makes them: numpy's RandomState(0), xproj
(seq - 1, 4, H, B) then wh (4, H, H), randn times 0.1.  It times a
chain of 30 calls, each feeding one element of its output into the
next call's input, with CUDA events (the host clock with --cpu, where the
plain version runs), three times with the inputs scaled by 1 + 1e-7 k,
and prints the fastest in ms a call and us a step.  It runs on the card
unless --cpu is given, and exits 1 without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from admm_lstm_torch.kernels.gate_sweep import floor_sweep
from admm_lstm_torch.utils.device import NoCudaDeviceError, resolve_device

CHAIN = 30
REPEATS = 3


def probe_inputs(seq: int, hidden: int, batch: int):
    """(xproj, wh) as float32 numpy arrays, as `bench_gs_floor.main`
    makes them."""
    rng = np.random.RandomState(0)
    xproj = rng.randn(seq - 1, 4, hidden, batch).astype(np.float32)
    wh = rng.randn(4, hidden, hidden).astype(np.float32)
    return xproj * np.float32(0.1), wh * np.float32(0.1)


def chain(xproj: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """CHAIN dependent `floor_sweep` calls: each adds 1e-30 of its last h
    to xproj's first row (in place) before the next.  Returns the last
    call's h."""
    for _ in range(CHAIN):
        h = floor_sweep(xproj, wh)
        xproj[0, 0, 0].add_(h[-1, 0], alpha=1e-30)
    return h


def measure(seq: int, hidden: int, batch: int,
            device: torch.device) -> dict:
    """The probe at (seq - 1, H, B) on `device`: the fastest of REPEATS
    chains in ms a call and us a step."""
    steps = seq - 1
    xproj, wh = (torch.from_numpy(a).to(device)
                 for a in probe_inputs(seq, hidden, batch))
    h = chain(xproj.clone(), wh)       # warm-up: builds the kernel
    if not bool(torch.isfinite(h).all()):
        raise AssertionError('floor_sweep returned non-finite values')
    times = []
    for rep in range(REPEATS):
        xp = xproj * (1 + (rep + 1) * 1e-7)
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            h = chain(xp, wh)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / CHAIN)
        else:
            t0 = time.perf_counter()
            h = chain(xp, wh)
            times.append((time.perf_counter() - t0) / CHAIN * 1e3)
    ms = min(times)
    return dict(steps=steps, hidden=hidden, batch=batch, ms=ms,
                us_per_step=ms / steps * 1e3,
                device=(torch.cuda.get_device_name(device)
                        if device.type == 'cuda' else 'cpu'))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seq', type=int, default=2048)
    parser.add_argument('--hidden', type=int, default=16)
    parser.add_argument('--batch', type=int, default=64)
    parser.add_argument('--cpu', action='store_true',
                        help='run the plain version on the CPU')
    args = parser.parse_args(argv)
    if args.seq < 2:
        parser.error('--seq must be at least 2 (one step)')
    try:
        device = resolve_device('cpu' if args.cpu else 'cuda')
    except NoCudaDeviceError as e:
        print(f'gs_floor: {e}', file=sys.stderr)
        return 1
    r = measure(args.seq, args.hidden, args.batch, device)
    clock = 'CUDA events' if device.type == 'cuda' else 'host clock'
    print(f'carry-chain floor (T={r["steps"]}, H={r["hidden"]}, '
          f'B={r["batch"]}) on {r["device"]}, {clock}: {r["ms"]!r} ms = '
          f'{r["us_per_step"]!r} us/step', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
