"""spans.py on synthetic kineto-like events worked out by hand, trace.py's
Trace of the same events with and without the spans, and the span
metrics of a traced run on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from portbench import run, spans, spec, trace
from portbench.spans import Event

BENCH = spec.benchmark()
TRAIN = 'googlestock_fast.train30'
SEARCH = 'googlestock_fast.rho_search27'
SMALL = {'B': 48, 'val': 12, 'H': 3}
NEW = ('unplanned_syncs_per_epoch.train',
       'line_search_reads_per_epoch.train',
       'weight_stage_launches_per_epoch.train',
       'weight_stage_host_ms_per_epoch.train',
       'unplanned_syncs_per_epoch.search',
       'weight_stage_device_ms_per_cand_epoch.search')


def _epoch(t0, corr):
    """One epoch from t0 (us): spans, a planned sync in each of two
    `read`s, an unplanned one in the x stage's copy, and a launch in each
    weight stage and one in the final step, their kernels on the device
    (the h stage's found by its linked operator only)."""
    return [
        Event(t0, t0 + 300, 'epoch', 'span', 0),
        Event(t0 + 10, t0 + 100, 'weights.x', 'span', 0),
        Event(t0 + 80, t0 + 90, 'read', 'span', 0),
        Event(t0 + 100, t0 + 200, 'weights.h', 'span', 0),
        Event(t0 + 200, t0 + 290, 'sweep.final', 'span', 0),
        Event(t0 + 250, t0 + 260, 'read', 'span', 0),
        # x stage: a launch, and an unplanned sync in a copy of `where`
        Event(t0 + 20, t0 + 30, 'aten::mul', 'op', 900 + corr),
        Event(t0 + 21, t0 + 25, 'cudaLaunchKernel', 'runtime', corr),
        Event(t0 + 38, t0 + 62, 'aten::where', 'op', 906 + corr),
        Event(t0 + 40, t0 + 60, 'aten::copy_', 'op', 901 + corr),
        Event(t0 + 41, t0 + 59, 'cudaStreamSynchronize', 'runtime', 0),
        Event(t0 + 81, t0 + 89, 'aten::_local_scalar_dense', 'op',
              902 + corr),
        Event(t0 + 82, t0 + 88, 'cudaStreamSynchronize', 'runtime', 0),
        # h stage: an operator whose kernel is linked to it alone
        Event(t0 + 120, t0 + 130, 'aten::add', 'op', 903 + corr),
        # final step: a launch and a planned sync
        Event(t0 + 210, t0 + 220, 'aten::tanh', 'op', 904 + corr),
        Event(t0 + 211, t0 + 215, 'cudaLaunchKernel', 'runtime', corr + 1),
        Event(t0 + 251, t0 + 259, 'aten::_local_scalar_dense', 'op',
              905 + corr),
        Event(t0 + 252, t0 + 258, 'cudaStreamSynchronize', 'runtime', 0),
        # the device: three kernels and the spans' mirrors
        Event(t0 + 30, t0 + 40, 'mul_kernel', 'device', corr),
        Event(t0 + 130, t0 + 134, 'add_kernel', 'device', 0, 903 + corr),
        Event(t0 + 220, t0 + 226, 'tanh_kernel', 'device', corr + 1),
        Event(t0 + 30, t0 + 226, 'epoch', 'mirror', 0),
        Event(t0 + 30, t0 + 40, 'weights.x', 'mirror', 0),
    ]


def _block():
    """Two epochs inside one `train`, and an unplanned sync after it."""
    evs = [Event(0, 1000, 'train', 'span', 0)]
    evs += _epoch(100, 1) + _epoch(500, 3)
    evs += [Event(1010, 1020, 'aten::item', 'op', 999),
            Event(1011, 1019, 'cudaStreamSynchronize', 'runtime', 0)]
    return evs


class _Kineto:
    """A kineto event as trace.py and spans.events read it."""

    def __init__(self, e: Event):
        self.e = e

    def start_ns(self):
        return int(self.e.start * 1000)

    def end_ns(self):
        return int(self.e.end * 1000)

    def name(self):
        return self.e.name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA
                if self.e.kind in ('device', 'mirror')
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self.e.kind in ('span', 'mirror')

    def correlation_id(self):
        return self.e.corr

    def linked_correlation_id(self):
        return self.e.linked


def _prof(evs):
    results = SimpleNamespace(events=lambda: [_Kineto(e) for e in evs])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_events_round_trip_through_the_kineto_reader():
    evs = _block()
    assert spans.events(_prof(evs)) == evs


def test_old_trace_fields_are_as_without_the_spans():
    """trace.py's Trace of a block with spans and their device mirrors is
    the Trace of the same block without them: the mirrors are neither
    operations nor busy time."""
    evs = _block()
    bare = [e for e in evs if e.kind not in ('span', 'mirror')]
    device = [(e.start, e.end, e.name) for e in bare if e.kind == 'device']
    host = [(e.start, e.end, e.name) for e in bare if e.kind != 'device']
    want = trace.summarize(device, host, 7, 0.002)
    assert trace.read((_prof(evs), 0.002)) == want
    assert trace.read((_prof(bare), 0.002)) == want
    assert spans.attribute(evs, 2, 54, 0.002)['trace'] == want
    assert len(want.device_ops) == 6 and want.syncs == 7
    assert want.busy_s == pytest.approx(2 * (10 + 4 + 6) * 1e-6)


def test_attribution_by_hand():
    out = spans.attribute(_block(), epochs=2, cand_epochs=54,
                          window_s=0.002)
    r = out['reading']
    # Two reads an epoch; the x stage's copy and the sync after `train`
    # are unplanned: 3 in all.
    assert r.reads == 4 and r.unplanned_syncs == 3
    assert dict(out['unplanned_syncs']) == {
        'train/epoch/weights.x > aten::where > aten::copy_': 2,
        '(no span) > aten::item': 1}
    # The x stage's kernel by its runtime call, the h stage's by its
    # operator: 2 an epoch, 10 + 4 us each epoch.
    assert r.weight_stage_launches == 4
    assert r.weight_stage_device_ms == pytest.approx(2 * 14e-3)
    assert r.weight_stage_host_ms == pytest.approx(2 * (90 + 100) * 1e-3)
    assert out['unmatched_ops'] == 0
    assert out['spans']['epoch'][0] == 2
    by = out['by_span']
    assert by['train/epoch/sweep.final'][1] == 2
    assert by['train/epoch/sweep.final/read'][0] == 2
    # Each gap by the span and operator at its midpoint: the x stage's
    # read, the h stage between operators, and `train` between epochs.
    gaps = dict(out['idle_gaps_by_span'])
    assert gaps == pytest.approx({
        'train/epoch/weights.x/read > aten::_local_scalar_dense': 2 * 90e-6,
        'train/epoch/weights.h > python (no operator)': 2 * 86e-6,
        'train > python (no operator)': 204e-6})


def test_spans_nest_and_find_the_innermost():
    sp = spans.Spans(_block())
    assert sp.path(sp.at(185)) == 'train/epoch/weights.x/read'
    assert sp.path(sp.at(105)) == 'train/epoch'
    assert sp.path(sp.at(450)) == 'train'
    assert sp.path(sp.at(1005)) == spans.NO_SPAN
    assert sp.path(sp.at(600)) == 'train/epoch/weights.h'


@pytest.mark.parametrize('name,value', [
    ('unplanned_syncs_per_epoch.train', 1.5),
    ('line_search_reads_per_epoch.train', 2.0),
    ('weight_stage_launches_per_epoch.train', 2.0),
    ('weight_stage_host_ms_per_epoch.train', 0.19),
    ('unplanned_syncs_per_epoch.search', 1.5),
    ('weight_stage_device_ms_per_cand_epoch.search', 28e-3 / 54)])
def test_each_metric_by_hand(name, value):
    ctx = SimpleNamespace(
        spans=spans.attribute(_block(), 2, 54, 0.002)['reading'])
    assert spec.reader('metrics', name)(ctx) == pytest.approx(value)


def test_no_device_operation_reads_no_device_metric():
    evs = [e for e in _block() if e.kind not in ('device', 'mirror')]
    ctx = SimpleNamespace(spans=spans.attribute(evs, 2, 54, 0.002)['reading'])
    assert spec.reader('metrics', NEW[1])(ctx) == 2.0
    for name in (NEW[0], NEW[2], NEW[4], NEW[5]):
        assert spec.reader('metrics', name)(ctx) is None


def test_run_seed_comes_from_the_command_line():
    assert spans.run_seed(['--workload', 'x', '--seed', '4294967311']) == (
        4294967311)
    assert spans.run_seed(['--seed=-3']) == -3
    assert spans.run_seed(['--trace', '1']) == 0


@pytest.mark.parametrize('cell', [TRAIN, SEARCH])
def test_a_traced_run_reads_the_span_metrics_on_the_cpu(monkeypatch, cell):
    """A traced run at small sizes on the CPU reads the host-side span
    metrics of its cell (no device operation there, so no device-side
    ones), beside the metrics it had; a program that opens no span
    (record_function a no-op) reads none and still runs."""
    traffic = spec.traffic(spec.workload(BENCH, cell)['traffic'])
    monkeypatch.setattr(spec, 'traffic', lambda name: {
        **traffic, 'epochs': 3, 'multipliers': [0.2, 1.0], 'keys': ['y'],
        'traced_jobs': 1, 'checked_jobs': 1})
    out = run.run_cell(BENCH, spec.workload(BENCH, cell), 11, 0.0, True,
                       device='cpu', sizes=SMALL)
    assert out['correct']
    got = {k for k in out['metrics'] if k in NEW}
    if cell == TRAIN:
        assert got == {'line_search_reads_per_epoch.train',
                       'weight_stage_host_ms_per_epoch.train'}
        assert out['metrics']['line_search_reads_per_epoch.train'][
            'value'] >= 2
    else:
        assert got == set()
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: __import__('contextlib').nullcontext())
    out = run.run_cell(BENCH, spec.workload(BENCH, cell), 11, 0.0, True,
                       device='cpu', sizes=SMALL)
    assert out['correct'] and not set(out['metrics']) & set(NEW)
