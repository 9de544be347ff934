"""The interior Gauss-Seidel sweep (admm_lstm_torch.kernels.gate_sweep):
its plain PyTorch version against the JAX package's Pallas kernel run in
interpret mode, and the wrapper's checks.  The CUDA kernel itself is held
against the plain version in tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu.kernels.gate_sweep import pallas_interior_sweep
from admm_lstm_torch.kernels.gate_sweep import (interior_sweep,
                                                interior_sweep_plain)

torch.set_num_threads(1)

# f32: different summation order in the H-long dot products and
# transcendental ulps between the implementations.
ATOL = 1e-5
RHO = np.asarray([1., 1., 1., 1., 0.01, 0.001], np.float32)


def _inputs(steps, batch, hidden, seed=0):
    rng = np.random.default_rng(seed)
    xproj = (rng.standard_normal((steps, 4, hidden, batch)) * 0.3).astype(np.float32)
    wh = (rng.standard_normal((4, hidden, hidden)) * 0.3).astype(np.float32)
    gates = tuple((rng.standard_normal((steps, hidden, batch)) * 0.2)
                  .astype(np.float32) for _ in range(6))
    duals = tuple((rng.standard_normal((steps, hidden, batch)) * 0.01)
                  .astype(np.float32) for _ in range(6))
    return xproj, wh, gates, duals


def _torch(args, device='cpu'):
    xproj, wh, gates, duals = args
    t = lambda a: torch.from_numpy(a).to(device)
    return (t(xproj), t(wh), tuple(map(t, gates)), tuple(map(t, duals)),
            t(RHO))


@pytest.mark.parametrize('steps,batch,hidden', [(13, 24, 5), (3, 17, 4)])
def test_torch_plain_sweep_matches_pallas(steps, batch, hidden):
    args = _inputs(steps, batch, hidden)
    xproj, wh, gates, duals = args
    ref_g, ref_d = pallas_interior_sweep(
        jnp.asarray(xproj), jnp.asarray(wh), tuple(map(jnp.asarray, gates)),
        tuple(map(jnp.asarray, duals)), jnp.asarray(RHO), interpret=True)
    new_g, new_d = interior_sweep_plain(*_torch(args))
    assert len(new_g) == 6 and len(new_d) == 5
    for k, (a, b) in enumerate(zip(new_g + new_d, ref_g + ref_d)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=f'output {k}')


def test_torch_sweep_wrapper_cpu_is_plain():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    args = _torch(_inputs(4, 9, 3, seed=1))
    before = interior_sweep.launches
    got = interior_sweep(*args)
    want = interior_sweep_plain(*args)
    assert interior_sweep.launches == before
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'contiguous', 'count'])
def test_torch_sweep_wrapper_rejects_bad_inputs(bad):
    xproj, wh, gates, duals, rho = _torch(_inputs(4, 9, 3, seed=2))
    if bad == 'dtype':
        xproj = xproj.double()
    elif bad == 'shape':
        wh = wh[:, :2]
    elif bad == 'contiguous':
        gates = (gates[0].transpose(1, 2).contiguous().transpose(1, 2),) + gates[1:]
    else:
        duals = duals[:5]
    with pytest.raises((TypeError, ValueError)):
        interior_sweep(xproj, wh, gates, duals, rho)
