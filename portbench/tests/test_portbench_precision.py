"""The TF32 flags as each side computes: read inside the program's epoch
step (where the model's `fault_targets` puts it) and inside the plain
reference's epoch, at every call.  For googlestock_fast both sides run in
full float32, so both flags read False on both sides, also after a run
of the control (the program at TF32) and after a traced run in the same
process: a flag that one run leaves behind for the next fails here."""

import contextlib

import pytest
import torch

from portbench import run, spec
from portbench.reference import admm_lstm as ref
from portbench.tests.test_portbench_faults import SMALL

BENCH = spec.benchmark()
OFF = {(False, False)}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def recorded(model):
    """{'program': [...], 'reference': [...]}: the flags at each call of
    the program's epoch step and of the reference's epoch in the body."""
    seen = {'program': [], 'reference': []}
    pairs = ([(m, attr, 'program') for m, attr in
              model.fault_targets()['step']]
             + [(ref, 'epoch', 'reference')])
    saved = [getattr(m, attr) for m, attr, _ in pairs]

    def wrap(real, side):
        def call(*args, **kw):
            seen[side].append(_flags())
            return real(*args, **kw)
        return call
    try:
        for (m, attr, side), real in zip(pairs, saved):
            setattr(m, attr, wrap(real, side))
        yield seen
    finally:
        for (m, attr, _), real in zip(pairs, saved):
            setattr(m, attr, real)


@pytest.mark.parametrize('cell', sorted(SMALL))
def test_both_sides_run_without_tf32_after_a_control_and_a_traced_run(cell):
    entry = spec.workload(BENCH, cell)
    model = spec.model(spec.config(entry['config'])['model'])

    def one(trace=False, control=False):
        with recorded(model) as seen:
            out = run.run_cell(BENCH, entry, 2 ** 31 + 17, 0.0, trace,
                               device='cpu', sizes=SMALL[cell],
                               control=control)
        assert seen['program'] and seen['reference'], seen
        return out, {k: set(v) for k, v in seen.items()}

    out, seen = one(control=True)
    assert seen == {'program': {(True, True)}, 'reference': OFF}
    out, seen = one(trace=True)
    assert seen == {'program': OFF, 'reference': OFF}
    assert out['correct'], out['checks']
    out, seen = one()
    assert seen == {'program': OFF, 'reference': OFF}
    assert out['correct'], out['checks']
