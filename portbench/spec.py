"""`BENCHMARK.json` and the files it names, found by name.

A cell `<config>.<traffic>` names a configuration `configs/<config>.json`,
a traffic mix `traffic/<traffic>.json` and its limits
`limits/<cell>.json`; an end-to-end metric is read by
`end_to_end/<name>.py` and a per-layer metric by `metrics/<name>.py`, each
a module with `read(ctx)`; a configuration's data comes from
`data/<kind>.py`.  Adding a cell, a configuration, a traffic mix or a
metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench['workloads']:
        if cell['name'] == name:
            return cell
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config(name: str) -> dict:
    return _json('configs', f'{name}.json')


def traffic(name: str) -> dict:
    return _json('traffic', f'{name}.json')


def limits(cell: str) -> dict:
    return _json('limits', f'{cell}.json')


def _module(folder: str, name: str):
    path = os.path.join(HERE, folder, f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'portbench.{folder}.{name.replace(".", "__")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(kind: str, name: str):
    """The `read` function of an end-to-end ('end_to_end') or per-layer
    ('metrics') metric."""
    return _module(kind, name).read


def data_source(kind: str):
    return _module('data', kind)


def metrics_of(bench: dict, cell: str, section: str) -> List[Dict]:
    """The entries of `section` ('end_to_end' or 'per_layer') that `cell`
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if cell in m.get('workloads', [cell])]
