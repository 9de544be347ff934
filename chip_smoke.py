"""Chip smoke run of the PyTorch/CUDA port (admm_lstm_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   - compile every CUDA kernel of the main path from csrc/ with
               nvcc (one process per source, all started together);
  2. kernels - hold each kernel against its plain PyTorch version on the
               card, at the main path's shape and two more, and time both
               with CUDA events (L2 flushed before every launch);
  3. train   - the main path: `admm_lstm_torch.api.train` on the bundled
               GoogleStock data, H=10, default ADMMConfig, 30 epochs, from
               the reference's seed-0 weights, held to the reference's
               loss trajectory; the kernels' launch counts are zeroed just
               before and read just after.
Then it prints the card's name and power limit, one JSON line describing
every kernel, and as the last line {"ok": true, "device": {...}}.
It exits non-zero, printing no result line, without a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'googlestock_fast.npz')
EPOCHS = 30
REF_VAL_30 = 0.346877           # the reference's 30-epoch validation loss
KERNEL_ATOL = 1e-5              # f32: summation order and transcendental ulps
# H100 SXM published peaks (NVIDIA data sheet): HBM rate and FP32 (non
# tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# (steps, H, B): the GoogleStock main path's shape first, then a ragged
# batch edge and a width whose wh (16 H^2 bytes) does not fit in shared
# memory.
SWEEP_SHAPES = [(9, 10, 4224), (13, 5, 1000), (31, 130, 512)]
SPIN_CYCLES = 1_000_000        # ~0.5 ms at the H100's ~2 GHz SM clock


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, flush):
    """Median device ms of `fn` over `reps` runs, each timed with CUDA
    events after overwriting a buffer larger than the 50 MB L2 cache.  A
    spin of ~0.5 ms on the device before the start event lets the host
    enqueue `fn`'s launches before the clock starts, so a kernel's time
    excludes its Python wrapper; a plain version that launches many small
    kernels still pays its host time between them."""
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def sweep_inputs(steps, hidden, batch, seed):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    xproj = rand(steps, 4, hidden, batch, scale=0.3)
    wh = rand(4, hidden, hidden, scale=0.3 / max(1.0, (hidden / 10) ** 0.5))
    gates = tuple(rand(steps, hidden, batch, scale=0.2) for _ in range(6))
    duals = tuple(rand(steps, hidden, batch, scale=s)
                  for s in (0.01,) * 5 + (1e-4,))
    rho = torch.tensor([1., 1., 1., 1., 0.008, 0.00045], device='cuda')
    return xproj, wh, gates, duals, rho


def sweep_bound(steps, hidden, batch):
    """(bound_ms, bound_by) for one interior sweep.  Bytes: the inputs the
    sweep reads (4 xproj gates, old f, g, c, h, 6 duals; old i and o do
    not enter the math), wh and rho once, the 11 outputs once.  Operations:
    8H per element and step for the four recurrent dot products plus 105
    for the closed forms, activations and duals (a transcendental counts
    as one)."""
    elems = steps * hidden * batch
    nbytes = 4 * (elems * (14 + 11) + 4 * hidden * hidden + 6)
    flops = elems * (8 * hidden + 105)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def phase_build():
    from admm_lstm_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all(['gate_sweep'])
    log(f'[build] gate_sweep.cu built in {time.perf_counter() - t0:.2f} s')
    for name, out in build.build_logs.items():
        for line in out.strip().splitlines():
            log(f'[build] {name}: {line}')


def phase_kernels(flush):
    from admm_lstm_torch.kernels.gate_sweep import (interior_sweep,
                                                    interior_sweep_plain)
    rows = []
    for k, (steps, hidden, batch) in enumerate(SWEEP_SHAPES):
        args = sweep_inputs(steps, hidden, batch, seed=k)
        got = interior_sweep(*args)
        want = interior_sweep_plain(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max())
                  for a, b in zip(got[0] + got[1], want[0] + want[1]))
        finite = all(bool(torch.isfinite(a).all()) for a in got[0] + got[1])
        ms = cuda_ms(lambda: interior_sweep(*args), 50, flush)
        plain_ms = cuda_ms(lambda: interior_sweep_plain(*args), 5, flush)
        bound_ms, bound_by = sweep_bound(steps, hidden, batch)
        row = dict(shape=[steps, hidden, batch], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f'[kernels] interior_sweep {row}')
        if not finite or not err <= KERNEL_ATOL:
            raise AssertionError(f'interior_sweep disagrees with its plain '
                                 f'version at {row["shape"]}: max abs err '
                                 f'{err} (atol {KERNEL_ATOL}), finite '
                                 f'{finite}')
        rows.append(row)
    return rows


def phase_train():
    from admm_lstm_torch import api
    from admm_lstm_torch.data import load_dataset
    from admm_lstm_torch.kernels.gate_sweep import interior_sweep
    from admm_lstm_torch.models.lstm import params_from_dict
    from admm_lstm_torch.utils.config import ADMMConfig

    g = np.load(GOLDEN)
    weights = {k[3:]: g[k] for k in g.files if k.startswith('w0_')}
    (tx, ty, vx, vy), ps, _ = load_dataset('GoogleStock')
    cfg = ADMMConfig(epochs=EPOCHS, hidden_size=10)

    interior_sweep.launches = 0
    res = api.train(tx, ty, vx, vy, ps, cfg, params=params_from_dict(weights),
                    log_every=0, device='cuda')
    launches = {'interior_sweep': interior_sweep.launches}

    train_l, val_l = np.asarray(res['train_loss']), np.asarray(res['val_loss'])
    ms_epoch = res['seconds'] * 1e3 / EPOCHS
    log(f'[train] GoogleStock H=10 {EPOCHS} epochs on the card: '
        f'{ms_epoch:.3f} ms/epoch (host clock, synchronized), final train '
        f'{train_l[-1]:.6f} val {val_l[-1]:.6f}, launches {launches}')
    log('[train] val trajectory ' + json.dumps([float(v) for v in val_l]))
    if not (np.all(np.isfinite(train_l)) and np.all(np.isfinite(val_l))):
        raise AssertionError('non-finite losses on the main path')
    np.testing.assert_allclose(train_l, g['train_loss'][:EPOCHS + 1],
                               rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(val_l, g['val_loss'][:EPOCHS + 1],
                               rtol=0.05, atol=1e-4)
    if not val_l[-1] <= REF_VAL_30 * 1.05:
        raise AssertionError(f'final val {val_l[-1]} above the reference '
                             f'{REF_VAL_30} x 1.05')
    if launches['interior_sweep'] < EPOCHS:
        raise AssertionError(f'the sweep kernel launched '
                             f'{launches["interior_sweep"]} times in '
                             f'{EPOCHS} epochs')

    # A second, warm run of the same work for the epoch time.
    res2 = api.train(tx, ty, vx, vy, ps, cfg, params=params_from_dict(weights),
                     log_every=0, device='cuda')
    log(f'[train] warm rerun: {res2["seconds"] * 1e3 / EPOCHS:.3f} ms/epoch')
    return launches


def card_name_and_power():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')
    from admm_lstm_torch.utils.device import set_matmul_precision
    from admm_lstm_torch.utils.logging import set_console_enabled
    set_console_enabled(False)
    set_matmul_precision('highest')
    torch.cuda.set_device(0)

    phase_build()
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device='cuda')
    rows = phase_kernels(flush)
    del flush
    launches = phase_train()

    card = card_name_and_power()
    log(f'[card] {card}')
    main_row = rows[0]
    kernels = [dict(
        name='interior_sweep', route='cuda',
        source='admm_lstm_torch/csrc/gate_sweep.cu',
        replaces='admm_lstm_tpu/kernels/gate_sweep.py:184',
        launches=launches['interior_sweep'],
        max_abs_err=main_row['max_abs_err'], ms=main_row['ms'],
        plain_ms=main_row['plain_ms'], bound_ms=main_row['bound_ms'],
        bound_by=main_row['bound_by'], library_ms=None,
        shape=main_row['shape'], other_shapes=rows[1:])]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
