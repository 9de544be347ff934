"""A golden run of each cell on the CPU: one seed, the small sizes of
test_portbench_faults.py, and everything that decides `correct`: job 0's
initial weights, the program's answers, the plain reference's answers and
the numbers that check.py compares, both as `check.compare` gives them
and as `run.run_cell` reports them.  The harness of this tree has to
reproduce the recorded file bit for bit; a number that check.py added
after the recording is not in it.

The file was recorded from the harness of an earlier commit, so a change
to the harness that alters what either side computes fails here.  To
record it again from a checkout at DIR (only the harness's `Workload`
with `weights`, `run` and `reference`, `check.compare`, `run.run_cell`
and test_portbench_faults.SMALL are used, which every commit since the
golden has):

    python portbench/tests/test_portbench_golden.py --root DIR --out FILE

Products on the CPU give the same bits for the same shapes, threads and
machine; both sides run on one thread.
"""

import argparse
import json
import math
import os
import sys

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'golden_googlestock_fast.json')
SEED = 2 ** 31 + 4242


def _plain(value):
    """Tensors, arrays, tuples and floats as JSON that keeps every bit
    (a float64 round-trips through its repr; float32 widens exactly)."""
    import numpy as np
    import torch
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return {'dtype': str(value.dtype).split('.')[-1],
                'shape': list(value.shape),
                'data': [_float(v) for v in value.double().flatten().tolist()]}
    if isinstance(value, np.ndarray):
        return {'dtype': str(value.dtype), 'shape': list(value.shape),
                'data': [_float(v) for v in value.astype(np.float64)
                         .flatten().tolist()]}
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return _float(value)


def _float(v):
    v = float(v)
    return v if math.isfinite(v) else repr(v)


def _cell_record(bench, name):
    import torch

    from portbench import check, run, spec
    from portbench.jobs import Workload
    from portbench.tests.test_portbench_faults import SMALL
    cell = spec.workload(bench, name)
    config = spec.config(cell['config'])
    traffic = spec.traffic(cell['traffic'])
    sizes = {**config['sizes'], **SMALL[name]}
    work = Workload(config, traffic, sizes, SEED, 'cpu')
    initial = work.weights(0)
    prog = work.run(0)
    refr = work.reference(0)
    compared = check.compare(work.kind, prog, refr)
    reported = run.run_cell(bench, cell, SEED, 0.0, False, device='cpu',
                            sizes=SMALL[name])
    assert isinstance(initial, tuple) and all(
        isinstance(w, torch.Tensor) for w in initial)
    return {'initial': _plain(initial), 'program': _plain(prog),
            'reference': _plain(refr), 'compared': _plain(compared),
            'checks': _plain({k: c['value']
                              for k, c in reported['checks'].items()}),
            'correct': reported['correct']}


def record(root=None):
    """The golden record of every cell, from the harness importable as
    `portbench` (the one under `root` where given)."""
    import torch

    from portbench import spec
    from admm_lstm_torch.utils.logging import set_console_enabled
    os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')
    set_console_enabled(False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bench = spec.benchmark(root or spec.ROOT)
        from portbench.tests.test_portbench_faults import SMALL
        return {'seed': SEED, 'sizes': SMALL,
                'cells': {name: _cell_record(bench, name)
                          for name in sorted(SMALL)}}
    finally:
        torch.set_num_threads(threads)
        set_console_enabled(True)


def test_the_harness_reproduces_the_golden_bit_for_bit():
    with open(GOLDEN) as f:
        golden = json.load(f)
    mine = json.loads(json.dumps(record()))
    assert golden['seed'] == SEED and golden['sizes'] == mine['sizes']
    for name, want in golden['cells'].items():
        got = mine['cells'][name]
        assert got['correct'] is True
        for part in ('initial', 'program', 'reference'):
            assert got[part] == want[part], (name, part)
        for part in ('compared', 'checks'):      # the numbers it recorded;
            assert {k: got[part][k] for k in want[part]} == want[part], (
                name, part)                       # later ones may be added
    assert set(mine['cells']) == set(golden['cells'])


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', required=True)
    parser.add_argument('--out', required=True)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    out = record(root)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
        f.write('\n')
