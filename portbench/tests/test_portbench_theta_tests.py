"""The theta tests' roofline share (metrics/theta_tests_roofline.search)
against values worked out by hand."""

from types import SimpleNamespace

import pytest

from portbench import spec
from portbench.trace import Trace

SIZES = {'B': 4224, 'T': 10, 'I': 1, 'H': 10, 'O': 1, 'val': 461}
KERNEL = ('void (anonymous namespace)::theta_tests_kernel<4>'
          '((anonymous namespace)::TestArgs)')


def _ctx(ops):
    trace = Trace(ops, 0, sum(s for _, s in ops), 1.0, {})
    return SimpleNamespace(trace=trace, sizes=SIZES, width=27)


def test_share_counts_every_traced_launch():
    # Three (27, 10, 40, 4224) slabs of f32 a launch: 547,430,400 bytes,
    # 0.163412 ms at 3.35 TB/s; 90 launches in 0.07 s.
    read = spec.reader('metrics', 'theta_tests_roofline.search')
    ops = [(KERNEL, 0.07 / 90)] * 90 + [('elementwise_kernel', 0.5)]
    bound = 3 * 4 * 27 * 10 * 40 * 4224 / 3.35e12
    assert read(_ctx(ops)) == pytest.approx(100 * bound * 90 / 0.07)
    assert bound == pytest.approx(0.163412e-3, rel=1e-5)


def test_no_launch_reads_nothing():
    read = spec.reader('metrics', 'theta_tests_roofline.search')
    assert read(_ctx([('elementwise_kernel', 0.5)])) is None
    assert read(SimpleNamespace(trace=None, sizes=SIZES, width=27)) is None
