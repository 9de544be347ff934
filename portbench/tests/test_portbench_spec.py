"""BENCHMARK.json against the contract's rules, and the files it names."""

import json
import os
import re
import shutil

import pytest

from portbench import run, spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
BENCH = spec.benchmark()
CELLS = [c['name'] for c in BENCH['workloads']]


def _one_line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_names_units_and_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert all(_one_line(w) for w in BENCH['command'])
    names = []
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert _one_line(c['source']) and _one_line(c['why'])
        assert c['file'].startswith('portbench/configs/')
        names.append(c['name'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and _one_line(w['why'])
        assert NAME.match(w['traffic']) and NAME.match(w['config'])
        names.append(w['name'])
    for section in ('end_to_end', 'per_layer'):
        for m in BENCH[section]:
            assert UNIT.match(m['unit']), m
            assert m['better'] in ('lower', 'higher')
            names.append(m['name'])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    layers = set()
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert _one_line(m['layer'])
        layers.add(m['layer'])
        for cell in m.get('workloads', CELLS):
            assert cell in CELLS
            assert cell in e2e[m['moves']].get('workloads', CELLS), (m, cell)
        if '_roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for cell in CELLS:
        reported = [m['name'] for m in spec.metrics_of(BENCH, cell,
                                                       'end_to_end')]
        assert 'setup_s' in reported and len(reported) >= 2
        assert spec.metrics_of(BENCH, cell, 'per_layer')


def test_every_named_file_exists():
    for c in BENCH['configs']:
        assert os.path.isfile(os.path.join(spec.ROOT, c['file']))
        config = spec.config(c['name'])
        assert config['name'] == c['name'] and config['reduced'] == []
    for w in BENCH['workloads']:
        spec.traffic(w['traffic'])
        assert set(spec.limits(w['name'])) >= {'loss_gap'}
    for section, folder in (('end_to_end', 'end_to_end'),
                            ('per_layer', 'metrics')):
        for m in BENCH[section]:
            assert callable(spec.reader(folder, m['name']))


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path,
                                                        monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell's limits
    and a per-layer metric as new files, and BENCHMARK.json entries; the
    harness runs the new cell without an edit to any existing file."""
    base = tmp_path / 'portbench'
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    config = spec.config('googlestock_fast')
    config['name'] = 'googlestock_tiny'
    config['sizes'] = {**config['sizes'], 'B': 48, 'val': 12, 'H': 3}
    (base / 'configs' / 'googlestock_tiny.json').write_text(
        json.dumps(config))
    (base / 'traffic' / 'train2.json').write_text(json.dumps(
        {'kind': 'train', 'epochs': 2, 'warmup_epochs': 1,
         'checked_jobs': 1, 'traced_jobs': 1}))
    (base / 'limits' / 'googlestock_tiny.train2.json').write_text(
        json.dumps({'loss_gap': 1e-4, 'weight_gap': 1e-3}))
    (base / 'metrics' / 'epochs_traced.train.py').write_text(
        'def read(ctx):\n    return float(len(ctx.traced_jobs))\n')
    monkeypatch.setattr(spec, 'HERE', str(base))
    bench = json.loads(json.dumps(BENCH))
    cell = {'name': 'googlestock_tiny.train2', 'config': 'googlestock_tiny',
            'traffic': 'train2', 'chips': 1, 'why': 'a test'}
    bench['workloads'].append(cell)
    bench['configs'].append({'name': 'googlestock_tiny', 'source': 'x',
                             'file': 'portbench/configs/g.json',
                             'reduced': [], 'why': 'a test'})
    bench['per_layer'].append(
        {'name': 'epochs_traced.train', 'unit': 'jobs', 'better': 'higher',
         'source': 'device_trace', 'layer': 'Epoch',
         'moves': 'train_epochs_per_s', 'workloads': [cell['name']]})
    for m in bench['end_to_end']:
        if m['name'] == 'train_epochs_per_s':
            m['workloads'].append(cell['name'])
    out = run.run_cell(bench, cell, 7, 0.0, True, device='cpu')
    assert out['correct'] and out['metrics']['epochs_traced.train'] == {
        'value': 1.0, 'unit': 'jobs'}
    out = run.run_cell(bench, cell, 7, 0.0, False, device='cpu')
    assert out['correct'] and set(out['metrics']) == {'train_epochs_per_s',
                                                      'setup_s'}
