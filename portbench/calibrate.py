"""Readings for the limits of `correct`, at a cell's own sizes, on the card.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3
        [--fault none|control|unchanged|half_batch|altered]

For each seed, runs the cell as a run of `run.py` does with a window of
no length (set-up, the first job, the plain reference's check of it),
with the fault of faults.py planted or, for `control`, the
configuration's lower-precision path of the program switched on, and
prints one JSON line of the numbers that check.py compares.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog='python -m portbench.calibrate')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--fault', default='none')
    args = parser.parse_args(argv)

    import torch

    from portbench import faults, run, spec

    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    for seed in map(int, args.seeds.split(',')):
        t0 = time.perf_counter()
        with faults.planted(args.fault):
            out = run.run_cell(bench, cell, seed, 0.0, False,
                               control=args.fault == 'control', t_start=t0)
        line = {'workload': args.workload, 'fault': args.fault, 'seed': seed,
                **{k: c['value'] for k, c in out['checks'].items()},
                'correct': out['correct'],
                'seconds': time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
