"""Build the CUDA kernels of this package and load them with ctypes.

Each source `admm_lstm_torch/csrc/<name>.cu` has a plain C interface and
is compiled by nvcc, for Hopper only, into a shared library under
`admm_lstm_torch/_build/` (listed in .gitignore), named by the hash of
its source and flags, at first use.  Nothing is compiled at import time,
and a failed build raises.  `build_all` starts one nvcc per source, all
together, and waits for them; the first load of a source of one of the
GROUPS (the fast epoch's main path; the stacked epoch's) builds the whole
group at once, so a cold start waits for one nvcc.  `launch` calls one
exported function on PyTorch's current stream and raises if it reports a
CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# Sources loaded together, built together: every fast epoch's (the
# weight stages' theta tests and the sweeps) and every stacked epoch's
# (layer 0's Gram kernel and Cholesky solves, and the stacked sweep).
GROUPS = (('gate_sweep', 'theta_tests'),
          ('cholesky', 'stacked_sweep', 'exact_gram'))

# Loaded libraries, and what each build printed.
_LIBS: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.isfile(path):
        raise KernelBuildError('nvcc not found (needed to build the CUDA '
                               'kernels; looked on PATH and in '
                               '/usr/local/cuda/bin)')
    return path


def _target(name: str) -> tuple:
    src = os.path.join(CSRC, f'{name}.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that has no up-to-date library, one
    nvcc process per source, all started together."""
    pending = {}
    for name in names:
        src, lib = _target(name)
        if not os.path.isfile(lib):
            pending[name] = (src, lib)
    if not pending:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, (src, lib) in pending.items():
        tmp = f'{lib}.{os.getpid()}.tmp'
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f'{name}.cu (nvcc exit {proc.returncode}):\n{out}')
        else:
            os.replace(tmp, lib)    # atomic: a reader never sees half a file
    if failed:
        raise KernelBuildError('kernel build failed: ' + '\n'.join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use (with the
    rest of its group in GROUPS, if it is in one)."""
    if name not in _LIBS:
        build_all([name, *(n for g in GROUPS if name in g for n in g)])
        _LIBS[name] = ctypes.CDLL(_target(name)[1])
    return _LIBS[name]


def launch(name: str, symbol: str, argtypes: Sequence, device: torch.device,
           *args, detail: str = '') -> None:
    """Calls `symbol` of csrc/<name>.cu with `args` (of ctypes types
    `argtypes`) and, last, the current stream of `device`.  Every exported
    function returns cudaGetLastError() after its launch; a non-zero
    value raises RuntimeError, with `detail` in the message."""
    fn = getattr(load_library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{symbol} launch failed: CUDA error {err} '
                           f'({detail})')
