"""The comparison that decides `correct` against faults planted in the
program, and against the configurations' controls: a run of the harness
on the CPU at small sizes, everything but the look for a card."""

import pytest
import torch

from portbench import faults, run, spec

BENCH = spec.benchmark()
SMALL = {'googlestock_fast.train30': {'B': 64, 'val': 16},
         'googlestock_fast.rho_search27': {'B': 32, 'val': 8}}


def _run(cell, fault='none', seed=12345, control=False, device='cpu'):
    with faults.planted(fault):
        return run.run_cell(BENCH, spec.workload(BENCH, cell), seed, 0.0,
                            False, device=device, sizes=SMALL[cell],
                            control=control)


@pytest.mark.parametrize('cell', sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    out = _run(cell, seed=2 ** 31 + 99)
    assert out['correct'] and out['failed'] == 0, out['checks']
    assert out['attempted'] >= 1


@pytest.mark.parametrize('fault', faults.FAULTS)
@pytest.mark.parametrize('cell', sorted(SMALL))
def test_a_planted_fault_is_caught(cell, fault):
    out = _run(cell, fault)
    assert not out['correct'], out['checks']


@pytest.mark.gpu
def test_the_tf32_control_is_caught_on_the_card():
    """googlestock_fast's control: the program at TF32 ('high'), which
    only a card has.  At the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: TF32 exists only there')
    for cell in ('googlestock_fast.train30', 'googlestock_fast.rho_search27'):
        with faults.planted('none'):
            out = run.run_cell(BENCH, spec.workload(BENCH, cell), 777, 0.0,
                               False, device='cuda', control=True)
        assert not out['correct'], out['checks']
