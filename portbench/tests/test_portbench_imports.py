"""What the benchmark loads: never JAX or the JAX package, and the plain
reference nothing of the program it judges.  Module names are compared by
their whole top-level name (the port's name begins with the JAX
package's)."""

import json
import os
import subprocess
import sys

from portbench import spec

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'admm_lstm_tpu')

_LOADED = '''
import json, sys
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
'''


def _top_level_after(body: str):
    out = subprocess.run([sys.executable, '-c', _LOADED.format(body=body)],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ,
                                           'ADMM_TORCH_NO_FILELOG': '1'})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_no_module_of_the_benchmark_loads_jax():
    body = '''
import os, pkgutil, importlib, portbench
from portbench import spec
for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):
    if '.tests' not in m.name:
        importlib.import_module(m.name)
bench = spec.benchmark()
for folder, section in (('end_to_end', 'end_to_end'), ('metrics', 'per_layer')):
    for m in bench[section]:
        spec.reader(folder, m['name'])
'''
    loaded = _top_level_after(body)
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_a_run_loads_the_port_and_not_jax():
    body = '''
from portbench import run, spec
bench = spec.benchmark()
cell = spec.workload(bench, 'googlestock_fast.rho_search27')
out = run.run_cell(bench, cell, 5, 0.0, False, device='cpu',
                   sizes={'B': 32, 'val': 8})
assert out['correct'], out
assert not run.forbidden_modules()
'''
    loaded = _top_level_after(body)
    assert 'admm_lstm_torch' in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level_after('import portbench.reference.admm_lstm')
    assert 'admm_lstm_torch' not in loaded
    assert not loaded & set(FORBIDDEN)
    assert loaded & {'torch', 'numpy'} == {'torch', 'numpy'}
