"""Static guard: the port and chip_smoke.py never import JAX or the JAX
package.

It walks the AST instead of checking sys.modules, because the test
process imports jax before any test runs (tests/conftest.py) and the
parity tests import both packages.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'admm_lstm_tpu')


def _sources():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(os.path.join(ROOT, 'admm_lstm_torch')):
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    return sorted(files)


def _bad_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or '']
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == '__import__' and node.args
              and isinstance(node.args[0], ast.Constant)):
            mods = [str(node.args[0].value)]
        else:
            continue
        bad += [f'{m} (line {node.lineno})' for m in mods
                if m.split('.')[0] in FORBIDDEN]
    return bad


def test_torch_port_sources_exist():
    assert os.path.isfile(os.path.join(ROOT, 'chip_smoke.py'))
    assert len(_sources()) > 10


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_torch_port_never_imports_jax(path):
    assert os.path.isfile(path), f'{path} is missing'
    assert _bad_imports(path) == []
