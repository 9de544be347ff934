"""The stacked configuration `googlestock_stacked2x40` and its cell: the
files found by name, the model module's contract on the CPU at a small
size, the planted faults, the operation count by hand, the span-path
metrics on synthetic events, and a reference that loads nothing of the
program."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import (check, faults, roofline, run, span_paths, spans,
                       spec, trace)
from portbench.spans import Event

BENCH = spec.benchmark()
CELL = 'googlestock_stacked2x40.rho_search27'
CONFIG = 'googlestock_stacked2x40'
SMALL = {'B': 48, 'val': 12, 'H': 6}
NEW = ('layer0_exact_device_ms_per_cand_epoch.stacked_search',
       'upper_solve_device_ms_per_cand_epoch.stacked_search',
       'sweep_launches_per_epoch.stacked_search',
       'chol_solve_roofline.stacked_search',
       'device_idle_share.stacked_search', 'mfu.stacked_search')


def _model():
    return spec.model(spec.config(CONFIG)['model'])


def _run(fault='none', seed=2 ** 31 + 77, trace_=False):
    with faults.planted(fault, _model()):
        return run.run_cell(BENCH, spec.workload(BENCH, CELL), seed, 0.0,
                            trace_, device='cpu', sizes=SMALL)


def test_the_files_are_found_by_name():
    config = spec.config(CONFIG)
    assert config['model'] == 'stacked_lstm' and config['reduced'] == []
    assert config['sizes'] == {'B': 4224, 'T': 10, 'I': 1, 'H': 40,
                               'layers': 2, 'O': 1, 'val': 461}
    model = _model()
    assert model.RHO_KEYS == ('i', 'f', 'g', 'o', 'c', 'h', 'y', 'z')
    assert set(config['rho']) == set(model.RHO_KEYS)
    cell = spec.workload(BENCH, CELL)
    assert (cell['config'], cell['traffic'], cell['chips']) == (
        CONFIG, 'rho_search27', 1)
    assert set(spec.limits(CELL)) - {'readings'} == set(
        check.NUMBERS['rho_search'])
    reported = {m['name'] for m in spec.metrics_of(BENCH, CELL,
                                                   'per_layer')}
    assert reported == set(NEW)
    assert {m['name'] for m in spec.metrics_of(BENCH, CELL, 'end_to_end')
            } == {'search_candidate_epochs_per_s', 'setup_s'}


def test_the_weights_are_each_layers_blocks():
    s = {**spec.config(CONFIG)['sizes'], **SMALL}
    w = _model().weights(11, 3, s, 'cpu')
    assert [tuple(t.shape) for t in w] == [
        (4, 1, 6), (4, 6, 6), (6, 1), (4, 6, 6), (4, 6, 6), (6, 1), (6, 1)]
    again = _model().weights(11, 3, s, 'cpu')
    assert all(torch.equal(a, b) for a, b in zip(w, again))
    other = _model().weights(11, 4, s, 'cpu')
    assert not torch.equal(w[0], other[0])


def test_a_sound_search_is_correct():
    out = _run(trace_=True)
    assert out['correct'] and out['failed'] == 0, out['checks']
    assert out['checks']['rank_regret']['value'] == 0.0
    # On the CPU the trace holds no device operation: the device metrics
    # read nothing, the host's read.
    assert set(out['metrics']) == {'device_idle_share.stacked_search',
                                   'mfu.stacked_search'}


def test_a_training_run_matches_the_reference():
    model = _model()
    config = spec.config(CONFIG)
    s = {**config['sizes'], **SMALL}
    data = spec.data_source(config['data']['kind']).load(
        {**config['data'], **s}, 5, 'cpu')
    w = model.weights(5, 1, s, 'cpu')
    prog = model.train(config, s, data, w, 4, 'cpu')
    refr = model.reference_train(config, data, w, 4)
    got = check.compare('train', prog, refr)
    assert got['loss_gap'] < 1e-6 and got['early_loss_gap'] < 1e-6, got
    assert [tuple(t.shape) for t in prog['weights']] == [
        tuple(t.shape) for t in refr['weights']]


@pytest.mark.parametrize('fault', faults.FAULTS)
def test_a_planted_fault_is_caught(fault):
    out = _run(fault)
    assert not out['correct'], out['checks']


def test_epoch_ops_by_hand():
    # B 4, Bv 2, T 3, I 2, H 3, two layers, O 1: N = 12, K = 12.
    s = {'B': 4, 'val': 2, 'T': 3, 'I': 2, 'H': 3, 'layers': 2, 'O': 1}
    n, k = 12, 12

    def side(d):              # Gram, first-order term, G w, solves
        return (2 * k * d * d * n + 2 * k * d * n + 2 * k * d * d
                + k * (d ** 3 / 3 + 2 * d * d))

    expect = (side(2) + side(3)
              + 2 * n * k * (2 * 2 + 3)               # x wx, h wh, fresh x wx
              + 2 * 6 * 6 * n + 2 * k * 6 * n         # upper: X X^T, T X^T
              + 4 * (6 ** 3 / 3 + 2 * 6 * 6 * 3)      # its four solves
              + 2 * n * k * (2 + 3)                   # sweep: layer 0
              + 2 * n * k * (3 + 3)                   # sweep: z input
              + 2 * n * (2 * k * 3 + 9) + 2 * k * 9   # coupled h, its M
              + 12 * 3 * 1 * 4                        # wy and the final h
              + 2 * 18 * (2 + 3) * k + 2 * 18 * 6 * k + 2 * 3 * 1 * 6)
    got = _model().epoch_ops(s, spec.config(CONFIG)['reference_rules'])
    assert got == pytest.approx(expect) and got == pytest.approx(21968)


def _block():
    """A search's one epoch: a launch in the x stage, two in the upper
    solve (one found by its linked operator only), three in the sweep and
    a sync in it, one in the final step."""
    return [
        Event(0, 1000, 'search', 'span', 0),
        Event(10, 990, 'group', 'span', 0),
        Event(20, 900, 'epoch', 'span', 0),
        Event(30, 90, 'weights.x', 'span', 0),
        Event(100, 200, 'weights.upper', 'span', 0),
        Event(200, 700, 'sweep.interior', 'span', 0),
        Event(700, 890, 'sweep.final', 'span', 0),
        Event(31, 33, 'cudaLaunchKernel', 'runtime', 1),
        Event(110, 112, 'cudaLaunchKernel', 'runtime', 2),
        Event(150, 160, 'aten::linalg_solve_ex', 'op', 50),
        Event(210, 212, 'cudaLaunchKernel', 'runtime', 3),
        Event(310, 312, 'cudaLaunchKernel', 'runtime', 4),
        Event(410, 412, 'cudaLaunchKernel', 'runtime', 5),
        Event(500, 520, 'cudaStreamSynchronize', 'runtime', 0),
        Event(710, 712, 'cudaLaunchKernel', 'runtime', 6),
        Event(40, 60, 'blocked_solve_kernel', 'device', 1),
        Event(120, 150, 'gemm', 'device', 2),
        Event(160, 200, 'getrf', 'device', 0, 50),
        Event(220, 230, 'mul', 'device', 3),
        Event(320, 330, 'add', 'device', 4),
        Event(420, 440, 'tanh', 'device', 5),
        Event(720, 725, 'sum', 'device', 6),
    ]


def test_span_paths_put_work_under_the_named_spans():
    out = spans.attribute(_block(), 1, 27, 0.001)
    assert span_paths.inside(out, 'weights.upper', 'ops') == 2
    assert span_paths.inside(out, 'weights.upper', 'device_ms') == \
        pytest.approx(0.07)
    assert span_paths.inside(out, 'sweep.interior', 'ops') == 3
    assert span_paths.inside(out, 'sweep.interior', 'syncs') == 1
    assert span_paths.inside(out, 'sweep.interior', 'device_ms') == \
        pytest.approx(0.04)
    assert span_paths.inside(out, 'epoch', 'ops') == 7
    ctx = SimpleNamespace(span_paths=out)
    read = lambda name: spec.reader('metrics', name)(ctx)
    assert read('upper_solve_device_ms_per_cand_epoch.stacked_search') == \
        pytest.approx(0.07 / 27)
    assert read('sweep_launches_per_epoch.stacked_search') == 3
    assert read('layer0_exact_device_ms_per_cand_epoch.stacked_search') == \
        pytest.approx(0.02 / 27)
    # A program without the spans (the parent of the stacked spans) or a
    # block that failed: no reading, and no error.
    for gone in (None, spans.attribute(
            [e for e in _block() if e.name not in ('weights.upper',
                                                   'sweep.interior')],
            1, 27, 0.001)):
        ctx = SimpleNamespace(span_paths=gone)
        assert read('upper_solve_device_ms_per_cand_epoch.stacked_search'
                    ) is None
        assert read('sweep_launches_per_epoch.stacked_search') is None


def test_span_block_is_profiled_once_for_every_span_metric(monkeypatch):
    calls = []

    def fake(ctx):
        calls.append(1)
        return spans.attribute(_block(), 1, 27, 0.001)

    monkeypatch.setattr(span_paths, '_profile', fake)
    ctx = SimpleNamespace(trace=object(), traced_jobs=[1])
    for name in NEW[:3]:
        assert spec.reader('metrics', name)(ctx) is not None
    assert calls == [1] and ctx.spans == ctx.span_paths['reading']
    assert spans.of(ctx) is ctx.spans


def test_chol_solve_roofline_counts_the_launches_it_finds():
    # One batched epoch: the x side's (1080, 1) solve and the h side's
    # (1080, 40), 6 us and 20 us.
    device = [(0, 6, 'void warp_chol_kernel<4>(float const*)'),
              (10, 30, 'void blocked_solve_kernel<64>(float const*)'),
              (40, 41, 'elementwise')]
    ctx = SimpleNamespace(trace=trace.summarize(device, [], 0, 1e-4),
                          width=27, sizes={'H': 10, 'I': 1})
    got = spec.reader('metrics', 'chol_solve_roofline.stacked_search')(ctx)
    bound = (roofline.solve_bound(1080, 1)[0]
             + roofline.solve_bound(1080, 10)[0])
    assert got == pytest.approx(100.0 * bound / 26e-6)
    ctx.trace = trace.summarize(device[2:], [], 0, 1e-4)
    assert spec.reader('metrics',
                       'chol_solve_roofline.stacked_search')(ctx) is None


def test_the_stacked_reference_loads_nothing_of_the_program():
    body = ('import json, sys\nimport portbench.reference.admm_stacked\n'
            'print(json.dumps(sorted({m.split(".")[0] '
            'for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', body], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, 'ADMM_TORCH_NO_FILELOG': '1'})
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & {'admm_lstm_torch', 'jax', 'jaxlib', 'flax',
                         'admm_lstm_tpu'}
    assert loaded & {'torch', 'numpy'} == {'torch', 'numpy'}
