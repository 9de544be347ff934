"""The fused stacked sweep's roofline share
(metrics/stacked_sweep_roofline.stacked_search) against values worked
out by hand."""

from types import SimpleNamespace

import pytest

from portbench import spec
from portbench.trace import Trace

SIZES = {'B': 4224, 'T': 10, 'I': 1, 'H': 40, 'layers': 2, 'O': 1,
         'val': 461}
SWEEP = ('void (anonymous namespace)::stacked_sweep_kernel<2, 2>'
         '((anonymous namespace)::SweepArgs)')
RESMAX = ('void (anonymous namespace)::stacked_resmax_kernel<4>'
          '((anonymous namespace)::ResmaxArgs)')
NAME = 'stacked_sweep_roofline.stacked_search'


def _ctx(ops):
    trace = Trace(ops, 0, sum(s for _, s in ops), 1.0, {})
    return SimpleNamespace(trace=trace, sizes=SIZES, width=27)


def test_bytes_at_the_stacked_cell():
    # 60 rows a t (30 read, 30 written), 30 zero rows written at t = 0 and
    # 12 rows a t read by the bounds' pass: 750 rows of (27, 40, 4224) f32,
    # 13.69 GB, 4.085 ms at 3.35 TB/s.  Launches that take exactly that
    # long read 100%.
    nbytes = 4 * 27 * 40 * 4224 * 750
    assert nbytes == 13_685_760_000
    bound = nbytes / 3.35e12
    assert bound == pytest.approx(4.0853e-3, rel=1e-4)
    read = spec.reader('metrics', NAME)
    ops = [(SWEEP, 0.9 * bound), (RESMAX, 0.1 * bound)]
    assert read(_ctx(ops)) == pytest.approx(100.0)


def test_share_counts_both_kernels_per_sweep_launch():
    read = spec.reader('metrics', NAME)
    ops = ([(SWEEP, 0.0085)] * 30 + [(RESMAX, 0.0007)] * 30
           + [('elementwise_kernel', 0.5)])
    bound = 13_685_760_000 / 3.35e12
    assert read(_ctx(ops)) == pytest.approx(100 * bound * 30 / (30 * 0.0092))
    assert 0 < read(_ctx(ops)) < 100


def test_no_launch_reads_nothing():
    read = spec.reader('metrics', NAME)
    assert read(_ctx([('elementwise_kernel', 0.5)])) is None
    assert read(SimpleNamespace(trace=None, sizes=SIZES, width=27)) is None
