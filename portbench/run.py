"""Run one cell of the benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The run needs a CUDA card (it exits 2
without one, printing no result), then:

  1. set-up (`setup_s`, from the start of this process): imports, CUDA,
     the cell's data on the device, and one short job at the cell's shapes
     that loads (and in a fresh checkout builds) the port's kernels;
  2. the window: the traffic's jobs back to back for `--seconds`; the job
     under way when the time is up finishes and counts, with its time;
     with `--trace 1` a few whole jobs inside it run under the profiler;
  3. the peak device memory, then the plain reference recomputes a sample
     of the window's jobs, drawn from the seed, and `correct` is decided
     (check.py); each number compared is printed beside its limit as the
     last lines of standard error and under `checks`, the last key of the
     result;
  4. one JSON line on standard output: with `--trace 0` the cell's
     end-to-end metrics, with `--trace 1` its per-layer ones and the
     breakdown of the traced jobs.

A run whose process holds jax, jaxlib, flax or the JAX package once the
window has closed exits 3 with no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'admm_lstm_tpu')


class JobTime(SimpleNamespace):
    """One job of the window: start and end (host clock, seconds; a
    profiled block's jobs share them, `count` of them), epochs,
    candidate-epochs, profiled or not."""


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m for m in sys.modules
                   if m.split('.')[0] in FORBIDDEN})


def power_limit():
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _ms(jobs):
    times = sorted((jb.end - jb.start) * 1e3 / jb.count for jb in jobs)
    if not times:
        return '-'
    return f'{times[len(times) // 2]:.1f}, {times[-1]:.1f} ({len(times)})'


def _sync(device):
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device='cuda', sizes=None, control=False,
             t_start=None) -> dict:
    """Steps 1-3 of a run on `device` (the CPU tests take 'cpu' and small
    `sizes`).  Returns the result without `device`: correct, attempted,
    failed, metrics, breakdown (traced), checks, and for the caller the
    traced busy and window seconds."""
    import torch

    from portbench import check, spec
    from portbench.jobs import Workload
    from portbench.trace import profiled, read

    t_start = T_START if t_start is None else t_start
    config = spec.config(cell['config'])
    traffic = spec.traffic(cell['traffic'])
    limits = spec.limits(cell['name'])
    sizes = {**config['sizes'], **(sizes or {})}
    os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')
    from admm_lstm_torch.utils.logging import set_console_enabled
    set_console_enabled(False)

    t_data = time.perf_counter()
    work = Workload(config, traffic, sizes, seed, device, control=control)
    _sync(device)
    t_warm = time.perf_counter()
    work.run(-2, traffic['warmup_epochs'])
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    _log(f'portbench: set-up {setup_s:.3f} s: imports and CUDA '
         f'{t_data - t_start:.3f}, data {t_warm - t_data:.3f}, warm-up job '
         f'{t0 - t_warm:.3f}')

    # The window.
    jobs, answers, failures = [], {}, []
    raw = None
    cpu0 = time.process_time()
    while True:
        j = len(jobs)
        n_prof = traffic['traced_jobs'] if trace and j == 1 else 0
        start = time.perf_counter()
        try:
            if n_prof:
                outs, raw = profiled(
                    lambda: [work.run(j + k) for k in range(n_prof)])
            else:
                outs = [work.run(j)]
        except Exception as e:     # a job that raises fails the run
            failures.append(f'job {j}: {type(e).__name__}: {e}')
            break
        end = time.perf_counter()
        for k, out in enumerate(outs):
            answers[j + k] = out
            jobs.append(JobTime(start=start, end=end, epochs=work.epochs,
                                cand_epochs=work.epochs * work.width,
                                profiled=bool(n_prof), count=len(outs)))
        if end - t0 >= seconds and (not trace or raw is not None):
            break
    _log(f'portbench: {cell["name"]} seed {seed}: {len(jobs)} jobs in '
         f'{jobs[-1].end - t0 if jobs else 0.0:.3f} s of window '
         f'({time.process_time() - cpu0:.3f} s of the process on the CPU); '
         f'{len(jobs)} runs behind the tail; set-up {setup_s:.3f} s')
    span = max(jobs[-1].end - t0 if jobs else 0.0, 1e-9)
    quarters = [[jb for jb in jobs if min(int(4 * (jb.end - t0) / span), 3)
                 == q] for q in range(4)]
    _log('portbench: job ms by quarter of the window (median, max): '
         + '; '.join(f'{_ms(q)}' for q in quarters))

    memory_peak = (torch.cuda.max_memory_allocated()
                   if torch.device(device).type == 'cuda' else 0)
    traced = None if raw is None else read(raw)
    raw = None

    # Correctness: a sample of the window's jobs, drawn from the seed.
    checked = sorted(random.Random(seed).sample(
        sorted(answers), min(traffic['checked_jobs'], len(answers))))
    kept = {j: answers[j] for j in checked}
    answers.clear()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    numbers = {name: 0.0 for name in check.NUMBERS[work.kind]}
    bad_jobs = 0
    for j in checked:
        got = check.compare(work.kind, kept[j], work.reference(j))
        bad_jobs += any(v > limits[k] for k, v in got.items())
        numbers = {k: max(numbers[k], got[k]) for k in numbers}
    correct = (not failures and bool(checked)
               and all(numbers[k] <= limits[k] for k in numbers))

    ctx = SimpleNamespace(
        cell=cell, config=config, traffic=traffic, sizes=sizes,
        model=work.model, width=work.width, setup_s=setup_s, window_start=t0,
        trace=traced,
        jobs=[jb for jb in jobs if not jb.profiled],
        traced_jobs=[jb for jb in jobs if jb.profiled])
    section = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in spec.metrics_of(bench, cell['name'], section):
        value = spec.reader('metrics' if trace else 'end_to_end',
                            m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': correct, 'attempted': len(jobs),
              'failed': len(failures) + bad_jobs, 'metrics': metrics,
              'memory_peak_bytes': memory_peak, 'failures': failures,
              'checks': {k: {'value': numbers[k], 'limit': limits[k]}
                         for k in numbers}}
    if traced is not None:
        result['breakdown'] = {
            'device_ops': [[n, s] for n, s in traced.top_ops()],
            'idle_gaps': [[n, s] for n, s in traced.top_gaps()]}
        result['busy_s'], result['window_s'] = traced.busy_s, traced.window_s
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='python -m portbench.run')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import spec
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell['chips']):
        _log(f'portbench: {args.workload} needs {cell["chips"]} CUDA '
             f'card(s); found {torch.cuda.device_count()}')
        return 2
    torch.set_num_threads(1)
    watts = power_limit()
    kind = torch.cuda.get_device_name(0)
    _log(f'portbench: {kind}, power limit {watts} W')

    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        _log(f'portbench: the process holds {", ".join(found)}')
        return 3
    device = {'platform': 'gpu', 'kind': kind, 'count': cell['chips'],
              'memory_peak_bytes': int(result.pop('memory_peak_bytes')),
              'power_limit_w': watts}
    if 'busy_s' in result:
        device['busy_s'] = result.pop('busy_s')
        device['window_s'] = result.pop('window_s')
    for failure in result.pop('failures'):
        _log(f'portbench: {failure}')
    checks = result.pop('checks')
    for c in checks.values():     # JSON has no infinity: a gap that is
        if not math.isfinite(c['value']):        # one reads as a string
            c['value'] = str(c['value'])
    line = {**result, 'device': device, 'checks': checks}
    for name, c in checks.items():
        _log(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
