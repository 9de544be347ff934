"""The Gauss-Seidel serial-floor probe (admm_lstm_torch.kernels.gate_sweep.
floor_sweep and admm_lstm_torch.gs_floor): the plain version against the
JAX probe's Pallas kernel run in interpret mode and against the JAX
package's LSTM forward, the kernels' launch plan (floor_plan), the
wrapper's checks, and the probe's command line.  The CUDA kernels
themselves are held against the plain version in
tests/test_torch_gpu.py."""

import functools
import importlib.util
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from admm_lstm_tpu.models import lstm as jl
from admm_lstm_torch import gs_floor
from admm_lstm_torch.kernels.gate_sweep import (FLOOR_AHEAD,
                                                FLOOR_MAX_WARPS,
                                                FLOOR_WARP_MAX_H,
                                                floor_plan, floor_sweep,
                                                floor_sweep_plain,
                                                sweep_plan)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32: different summation order in the H-long dot products and
# transcendental ulps between the implementations.
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_probe():
    """benchmarks/bench_gs_floor.py loaded from its file (the folder is no
    package), its `pl` swapped for one whose pallas_call runs in interpret
    mode, as the JAX package's tests run its kernels on the CPU."""
    path = os.path.join(ROOT, 'benchmarks', 'bench_gs_floor.py')
    spec = importlib.util.spec_from_file_location('bench_gs_floor', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{
        **vars(pl), 'pallas_call': functools.partial(pl.pallas_call,
                                                     interpret=True)})
    return mod


def _inputs(steps, hidden, batch, seed):
    rng = np.random.default_rng(seed)
    xproj = (rng.standard_normal((steps, 4, hidden, batch)) * 0.3)
    wh = rng.standard_normal((4, hidden, hidden)) * 0.4
    return xproj.astype(np.float32), wh.astype(np.float32)


@pytest.mark.parametrize('steps,hidden,batch', [
    (20, 8, 16),
    (33, 5, 8),        # steps not a multiple of the JAX time block (16)
    (16, 16, 24),
    (17, 32, 8),       # the widest H of the warp-synchronous kernel
    (17, 33, 8),       # the narrowest on interior_sweep's tile plan
])
def test_torch_floor_plain_matches_pallas(steps, hidden, batch):
    xproj, wh = _inputs(steps, hidden, batch, seed=steps)
    ref = np.asarray(_jax_probe().floor_sweep(jnp.asarray(xproj),
                                              jnp.asarray(wh)))
    got = floor_sweep_plain(torch.from_numpy(xproj), torch.from_numpy(wh))
    assert got.shape == (steps, hidden, batch)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize('seq_len,inp,hidden,batch', [
    (12, 3, 6, 16),
    (9, 2, 5, 13),     # a ragged batch
])
def test_torch_floor_plain_matches_lstm_history(seq_len, inp, hidden, batch):
    """The same recurrence as the JAX forward, from xproj = x wx (the
    forward has no bias): its 'h' slabs without row 0, as (T, H, B)."""
    rng = np.random.default_rng(seq_len)
    x = rng.standard_normal((batch, seq_len, inp)).astype(np.float32)
    wx = (rng.standard_normal((4, inp, hidden)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((4, hidden, hidden)) * 0.4).astype(np.float32)
    wy = np.zeros((hidden, 1), np.float32)
    ref = jl.lstm_forward_with_history(
        jl.LSTMParams(*map(jnp.asarray, (wx, wh, wy))), jnp.asarray(x))['h']
    ref = np.transpose(np.asarray(ref)[1:], (0, 2, 1))
    xproj = np.einsum('bti,gih->tghb', x, wx).astype(np.float32)
    got = floor_sweep_plain(torch.from_numpy(np.ascontiguousarray(xproj)),
                            torch.from_numpy(wh))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


# The H100's SM count and the shared memory a block may opt in to.
H100_SMS, H100_SMEM = 132, 232_448


@pytest.mark.parametrize('batch', [1, 37, 64, 4224])
@pytest.mark.parametrize('hidden',
                         [1, 3, 5, 7, 10, 16, 17, 32, 33, 64, 130, 2048])
def test_torch_floor_plan(hidden, batch):
    """Up to 32 hidden units the warp-synchronous kernel: H lanes a
    column, 32 // H columns a warp, a product H rounded up to a power of
    two long, a grid that covers B with no empty block, one warp a block
    while the warps fit the SMs one each; above, interior_sweep's tile
    plan."""
    plan = floor_plan(hidden, batch, H100_SMS, H100_SMEM)
    assert 0 <= plan.smem <= H100_SMEM
    if hidden > FLOOR_WARP_MAX_H:
        sweep = sweep_plan(hidden, batch, H100_SMS, H100_SMEM)
        assert plan.route == 'sweep' and plan.sweep == sweep
        assert (plan.lanes, plan.warps, plan.cols) == (0, 0, 0)
        assert (plan.grid, plan.smem) == (sweep.grid, sweep.smem)
        assert sweep.grid * sweep.tb >= batch
        return
    assert plan.route == 'warp' and plan.sweep is None
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.lanes >= hidden and (plan.lanes == 1
                                     or plan.lanes // 2 < hidden)
    assert plan.cols == 32 // hidden
    warps = -(-batch // plan.cols)
    assert 1 <= plan.warps <= FLOOR_MAX_WARPS
    assert plan.warps == 1 or warps > H100_SMS
    per_block = plan.warps * plan.cols
    assert plan.grid * per_block >= batch > (plan.grid - 1) * per_block
    # FLOOR_AHEAD + 1 slots of 4 floats a thread
    assert plan.smem == 16 * (FLOOR_AHEAD + 1) * 32 * plan.warps


@pytest.mark.parametrize('hidden,batch,sms', [
    (0, 64, 132), (2049, 64, 132), (4096, 1, 132), (16, 0, 132),
    (16, 64, 0),
])
def test_torch_floor_plan_refuses(hidden, batch, sms):
    """An empty sweep, a card without SMs, or H beyond the kernels."""
    with pytest.raises(ValueError):
        floor_plan(hidden, batch, sms, H100_SMEM)


def test_torch_floor_wrapper_on_cpu_is_the_plain_version():
    xproj, wh = (torch.from_numpy(a) for a in _inputs(7, 4, 5, seed=1))
    before = floor_sweep.launches
    assert torch.equal(floor_sweep(xproj, wh), floor_sweep_plain(xproj, wh))
    assert floor_sweep.launches == before


@pytest.mark.parametrize('case,error', [
    ('xproj_rank', ValueError),
    ('gates', ValueError),
    ('wh_shape', ValueError),
    ('dtype', TypeError),
    ('contiguous', ValueError),
    ('empty', ValueError),
    ('device', ValueError),
])
def test_torch_floor_wrapper_checks(case, error):
    xproj, wh = (torch.from_numpy(a) for a in _inputs(3, 4, 6, seed=2))
    bad = {
        'xproj_rank': lambda: (xproj[0], wh),
        'gates': lambda: (xproj[:, :3], wh),
        'wh_shape': lambda: (xproj, wh[:, :3]),
        'dtype': lambda: (xproj.double(), wh),
        'contiguous': lambda: (xproj.transpose(2, 3).contiguous()
                               .transpose(2, 3)[..., :5], wh),
        'empty': lambda: (xproj[:0], wh),
        'device': lambda: (xproj, wh.to('meta')),
    }[case]()
    with pytest.raises(error):
        floor_sweep(*bad)


def test_torch_floor_probe_inputs_match_the_jax_probe():
    """gs_floor makes the JAX probe's inputs: RandomState(0), xproj then
    wh, randn in float32 times 0.1."""
    rng = np.random.RandomState(0)
    want = (rng.randn(8, 4, 4, 8).astype(np.float32) * 0.1,
            rng.randn(4, 4, 4).astype(np.float32) * 0.1)
    got = gs_floor.probe_inputs(9, 4, 8)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_torch_floor_probe_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, '-m', 'admm_lstm_torch.gs_floor', '--cpu', '--seq',
         '9', '--hidden', '4', '--batch', '8'], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS='1'), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'carry-chain floor (T=8, H=4, B=8) on cpu' in proc.stdout
    assert 'us/step' in proc.stdout


def test_torch_floor_probe_without_card_or_cpu_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert gs_floor.main(['--seq', '9', '--hidden', '4', '--batch', '8']) == 1
    out = capsys.readouterr()
    assert 'no CUDA device was found' in out.err
    assert 'carry-chain floor' not in out.out
