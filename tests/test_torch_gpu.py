"""Tests of the port's CUDA kernels; they need a CUDA card and skip
without one.  This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.step import make_admm_step
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.kernels.gate_sweep import (interior_sweep,
                                                interior_sweep_plain)
from admm_lstm_torch.models.lstm import init_lstm_params
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.device import set_matmul_precision

# f32: different summation order in the H-long dot products and
# transcendental ulps between the kernel and the plain version.
ATOL = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA kernel has no CPU mode')
    set_matmul_precision('highest')
    return torch.device('cuda')


def _inputs(steps, hidden, batch, seed, device):
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *s, scale: (torch.randn(s, generator=gen) * scale).to(device)
    xproj = rand(steps, 4, hidden, batch, scale=0.3)
    wh = rand(4, hidden, hidden, scale=0.3 / max(1.0, (hidden / 10) ** 0.5))
    gates = tuple(rand(steps, hidden, batch, scale=0.2) for _ in range(6))
    # lambda_h stays small, as on the main path (its rows t < T are zero):
    # h carries lambda_h / rho_h, and large h would hide the kernel's f32
    # error behind the ulps of the values themselves.
    duals = tuple(rand(steps, hidden, batch, scale=s)
                  for s in (0.01,) * 5 + (1e-4,))
    rho = torch.tensor([1., 1., 1., 1., 0.008, 0.00045], device=device)
    return xproj, wh, gates, duals, rho


@pytest.mark.parametrize('steps,hidden,batch', [
    (9, 10, 4224),     # GoogleStock
    (13, 5, 1000),     # ragged batch edge
    (31, 130, 512),    # wh read through L2
    (1, 3, 1),         # one step, one column
    (3, 700, 40),      # the batch tile narrows below a warp
])
def test_torch_cuda_sweep_matches_plain(cuda, steps, hidden, batch):
    args = _inputs(steps, hidden, batch, seed=steps, device=cuda)
    before = interior_sweep.launches
    got = interior_sweep(*args)
    torch.cuda.synchronize()
    assert interior_sweep.launches == before + 1
    want = interior_sweep_plain(*args)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_torch_cuda_step_kernel_matches_plain_loop(cuda):
    """Three epochs with the kernel and with the plain loop on the card."""
    tx, ty, _, _ = synth(batch=300, seq_len=6, input_size=2, val_batch=4)
    x, y = torch.from_numpy(tx).to(cuda), torch.from_numpy(ty).to(cuda)
    params = init_lstm_params(torch.Generator().manual_seed(0), 2, 7, 1,
                              device=cuda)
    ps = parameter_set('Synthetic')
    states = {}
    for flag in (True, False):
        cfg = ADMMConfig(use_pallas_sweep=flag)
        st = init_admm_state(params, x, ps, cfg)
        step = make_admm_step(cfg)
        before = interior_sweep.launches
        for _ in range(3):
            st = step(st, x, y)
        assert interior_sweep.launches - before == (3 if flag else 0)
        states[flag] = st
    for k in ('i', 'f', 'g', 'o', 'c', 'h'):
        np.testing.assert_allclose(
            getattr(states[True].gates, k).cpu().numpy(),
            getattr(states[False].gates, k).cpu().numpy(), atol=1e-4)
