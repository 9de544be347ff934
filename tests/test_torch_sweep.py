"""The interior Gauss-Seidel and Jacobi sweeps
(admm_lstm_torch.kernels.gate_sweep): their plain PyTorch versions against
the JAX package's Pallas kernels run in interpret mode, and the wrappers'
checks.  The CUDA kernels themselves are held against the plain versions
in tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu.kernels.gate_sweep import (pallas_interior_sweep,
                                              pallas_jacobi_sweep)
from admm_lstm_torch.kernels.gate_sweep import (SWEEP_TILES, interior_sweep,
                                                interior_sweep_plain,
                                                jacobi_sweep,
                                                jacobi_sweep_plain,
                                                padded_wh, sweep_plan)

torch.set_num_threads(1)

# f32: different summation order in the H-long dot products and
# transcendental ulps between the implementations.
ATOL = 1e-5
RHO = np.asarray([1., 1., 1., 1., 0.01, 0.001], np.float32)


def _inputs(steps, batch, hidden, seed=0):
    """Random sweep inputs; wh shrinks as 1/sqrt(H) above H = 10.  Above
    H = 10 lambda_h is small, as on the main path (its rows t < T are
    zero): h carries lambda_h / rho_h, and values ~60 would put their own
    f32 ulps above the tolerance."""
    rng = np.random.default_rng(seed)
    xproj = (rng.standard_normal((steps, 4, hidden, batch)) * 0.3).astype(np.float32)
    wh = (rng.standard_normal((4, hidden, hidden))
          * (0.3 / max(1.0, (hidden / 10) ** 0.5))).astype(np.float32)
    gates = tuple((rng.standard_normal((steps, hidden, batch)) * 0.2)
                  .astype(np.float32) for _ in range(6))
    lam_h = 0.01 if hidden <= 10 else 1e-4
    duals = tuple((rng.standard_normal((steps, hidden, batch)) * scale)
                  .astype(np.float32) for scale in (0.01,) * 5 + (lam_h,))
    return xproj, wh, gates, duals


def _torch(args, device='cpu'):
    xproj, wh, gates, duals = args
    t = lambda a: torch.from_numpy(a).to(device)
    return (t(xproj), t(wh), tuple(map(t, gates)), tuple(map(t, duals)),
            t(RHO))


@pytest.mark.parametrize('steps,batch,hidden', [
    (13, 24, 5), (3, 17, 4),
    (31, 8, 16),     # long T, narrow B
    (3, 6, 130),     # H past 128
])
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


# An H100's SM count and shared memory per block (opt-in).
H100_SMS = 132
H100_SMEM = 232448
# Rows per thread -> the threads per block the kernel is compiled for
# (csrc/gate_sweep.cu::sweep_max_threads).
MAX_THREADS = {1: 1024, 2: 512, 4: 512}


@pytest.mark.parametrize('batch', [1, 37, 512, 1000, 4224])
@pytest.mark.parametrize('hidden', [1, 5, 10, 100, 108, 109, 130, 700])
def test_torch_sweep_plan_fills_the_card(hidden, batch):
    """The Gauss-Seidel kernel's tile plan: at least min(SMs, ceil(B / 8))
    blocks, shared memory within the limit, a tile that divides a warp,
    threads and rows that cover H, and wh streamed only where it does not
    fit."""
    plan = sweep_plan(hidden, batch, H100_SMS, H100_SMEM)
    assert plan.grid == -(-batch // plan.tb)
    assert plan.grid >= min(H100_SMS, -(-batch // 8))
    assert 0 < plan.smem <= H100_SMEM
    assert plan.tb in SWEEP_TILES and 32 % plan.tb == 0
    assert plan.rows in MAX_THREADS and (plan.rows > 1) == (hidden >= 32)
    groups = -(-hidden // plan.rows)
    assert plan.threads == plan.tb * groups <= MAX_THREADS[plan.rows]
    assert plan.hp == groups * plan.rows
    streamed = plan.resident < hidden
    assert 0 <= plan.resident <= hidden and (plan.chunk > 0) == streamed
    wh_floats = (plan.resident + 2 * plan.chunk) * 4 * plan.hp
    assert plan.smem == 4 * (wh_floats + 2 * hidden * plan.tb)
    if streamed:
        assert plan.padded
        assert 16 * hidden * plan.hp + 8 * hidden * plan.tb > H100_SMEM


def test_torch_sweep_plan_main_shapes():
    """GoogleStock fills the 132 SMs with warp-wide tiles and wh resident;
    B = 512 gets at least 64 blocks (a 32-column tile gave 16); H = 130
    streams part of wh; B = 300 at H = 96 takes one wave of 4-column tiles,
    not three of single columns; H beyond the kernel raises."""
    plan = sweep_plan(10, 4224, H100_SMS, H100_SMEM)
    assert (plan.tb, plan.grid, plan.resident) == (32, 132, 10)
    for hidden in (16, 130):
        assert sweep_plan(hidden, 512, H100_SMS, H100_SMEM).grid >= 64
    assert 0 < sweep_plan(130, 512, H100_SMS, H100_SMEM).resident < 130
    assert sweep_plan(100, 4224, H100_SMS, H100_SMEM).resident == 100
    assert sweep_plan(96, 300, H100_SMS, H100_SMEM).grid == 75
    with pytest.raises(ValueError):
        sweep_plan(2049, 16, H100_SMS, H100_SMEM)


def test_torch_sweep_padded_wh_layout():
    """The kernel's padded wh: wh[g][k][j] at [k][j][g], zero past H."""
    wh = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 5, 5)).astype(np.float32))
    whp = padded_wh(wh, 8)
    assert whp.shape == (5, 8, 4) and whp.is_contiguous()
    for g in range(4):
        for k in range(5):
            assert torch.equal(whp[k, :5, g], wh[g, k])
    assert not whp[:, 5:, :].any()


def _jacobi_inputs(steps, batch, hidden, seed=0):
    rng = np.random.default_rng(seed)
    pre = (rng.standard_normal((steps, 4, hidden, batch)) * 0.5).astype(np.float32)
    slab = lambda scale: (rng.standard_normal((steps, hidden, batch))
                          * scale).astype(np.float32)
    gates = tuple(slab(0.2) for _ in range(6))
    duals = tuple(slab(0.01) for _ in range(6))
    return pre, gates, duals, slab(0.2), slab(0.2)


@pytest.mark.parametrize('steps,batch,hidden', [(9, 24, 5), (4, 17, 4)])
def test_torch_plain_jacobi_matches_pallas(steps, batch, hidden):
    pre, gates, duals, h_prev, c_prev = _jacobi_inputs(steps, batch, hidden)
    j = jnp.asarray
    ref_g, ref_d = pallas_jacobi_sweep(
        j(pre), tuple(map(j, gates)), tuple(map(j, duals)), j(h_prev),
        j(c_prev), j(RHO), interpret=True)
    t = torch.from_numpy
    new_g, new_d = jacobi_sweep_plain(
        t(pre), tuple(map(t, gates)), tuple(map(t, duals)), t(h_prev),
        t(c_prev), t(RHO))
    assert len(new_g) == 6 and len(new_d) == 5
    for k, (a, b) in enumerate(zip(new_g + new_d, ref_g + ref_d)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=f'output {k}')


def _jacobi_torch(seed):
    pre, gates, duals, h_prev, c_prev = _jacobi_inputs(3, 9, 4, seed=seed)
    t = torch.from_numpy
    return (t(pre), tuple(map(t, gates)), tuple(map(t, duals)), t(h_prev),
            t(c_prev), t(RHO))


def test_torch_jacobi_wrapper_cpu_is_plain():
    args = _jacobi_torch(seed=4)
    before = jacobi_sweep.launches
    got = jacobi_sweep(*args)
    want = jacobi_sweep_plain(*args)
    assert jacobi_sweep.launches == before
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'contiguous', 'count'])
def test_torch_jacobi_wrapper_rejects_bad_inputs(bad):
    pre, gates, duals, h_prev, c_prev, rho = _jacobi_torch(seed=5)
    if bad == 'dtype':
        c_prev = c_prev.double()
    elif bad == 'shape':
        h_prev = h_prev[:, :2].contiguous()
    elif bad == 'contiguous':
        pre = pre.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        gates = gates[:5]
    with pytest.raises((TypeError, ValueError)):
        jacobi_sweep(pre, gates, duals, h_prev, c_prev, rho)
