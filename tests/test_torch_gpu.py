"""Tests of the port's CUDA kernels (the Gauss-Seidel and Jacobi sweeps,
the batched Cholesky solve and inverse); they need a CUDA card and skip
without one.  This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.step import make_admm_step
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.kernels.cholesky import (chol_inverse,
                                              chol_inverse_plain, chol_solve,
                                              chol_solve_plain)
from admm_lstm_torch.kernels.gate_sweep import (JacobiPlan,
                                                card_jacobi_plan,
                                                card_sweep_plan,
                                                interior_sweep,
                                                interior_sweep_plain,
                                                jacobi_sweep,
                                                jacobi_sweep_plain)
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


# B of the wh-residency threshold cases: the largest H whose wh the plan
# keeps in shared memory at this B, and the next H, which streams it.
THRESHOLD_BATCH = 512


def _resident_threshold(device, batch):
    hidden = 64
    while card_sweep_plan(device, hidden + 1, batch).resident == hidden + 1:
        hidden += 1
    return hidden


@pytest.mark.parametrize('steps,hidden,batch', [
    (9, 10, 4224),     # GoogleStock
    (13, 5, 1000),     # ragged batch edge
    (31, 130, 512),    # wh streamed through shared memory
    (1, 3, 1),         # one step, one column
    (3, 700, 40),      # the batch tile narrows below a warp
    (9, 100, 4224),    # GoogleStock at the reference's widest H
    (127, 16, 512),    # the JAX package's long-sequence shape
    (5, 10, 1001),     # B not a multiple of 4
    (4, 7, 37),        # odd H, B below one tile of 8
    (3, 'resident', THRESHOLD_BATCH),   # widest H with wh resident
    (3, 'streamed', THRESHOLD_BATCH),   # the next H, wh streamed
    (2, 120, 4224),    # four rows a thread with wh streamed
    (4, 64, 1001),     # two rows a thread, ragged batch edge
    (3, 40, 37),       # two rows a thread, one column a block
    (4, 300, 24),      # wh streamed, a partial last warp
    (59, 10, 1360),    # YahooFinance
    (56, 10, 85),      # DNA1
    (24, 10, 487),     # SMSSpam
    (23, 10, 10522),   # GEFCOM2012Wind
])
def test_torch_cuda_sweep_matches_plain(cuda, steps, hidden, batch):
    if isinstance(hidden, str):
        streamed = hidden == 'streamed'
        hidden = _resident_threshold(cuda, batch) + streamed
        plan = card_sweep_plan(cuda, hidden, batch)
        assert (plan.resident < hidden) == streamed
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


def _jacobi_inputs(steps, hidden, batch, device, offset=0):
    """Jacobi sweep inputs; with `offset`, each slab a view that starts
    `offset` floats into its buffer, as the interior views s[1:T] do."""
    gen = torch.Generator().manual_seed(steps + hidden)

    def rand(*shape, scale):
        flat = torch.randn(int(np.prod(shape)) + offset, generator=gen)
        return (flat * scale).to(device)[offset:].view(shape)

    pre = rand(steps, 4, hidden, batch, scale=0.5)
    gates = tuple(rand(steps, hidden, batch, scale=0.2) for _ in range(6))
    duals = tuple(rand(steps, hidden, batch, scale=s)
                  for s in (0.01,) * 5 + (1e-4,))
    h_prev, c_prev = (rand(steps, hidden, batch, scale=0.2) for _ in range(2))
    rho = torch.tensor([1., 1., 1., 1., 0.008, 0.00045], device=device)
    return pre, gates, duals, h_prev, c_prev, rho


def _jacobi_matches_plain(args):
    before = jacobi_sweep.launches
    got = jacobi_sweep(*args)
    torch.cuda.synchronize()
    assert jacobi_sweep.launches == before + 1
    want = jacobi_sweep_plain(*args)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize('steps,hidden,batch', [
    (9, 10, 4224),     # GoogleStock
    (9, 128, 2048),    # the HAR-shaped turbo run
    (13, 5, 1000),     # ragged batch edge
    (1, 3, 1),
    (5, 7, 1001),      # B % 4 != 0: V = 1
    (9, 20, 2052),     # float4s, several rounds, a partial last block
    (7, 33, 3001),     # V = 1, several rounds, a partial last block
])
def test_torch_cuda_jacobi_matches_plain(cuda, steps, hidden, batch):
    _jacobi_matches_plain(_jacobi_inputs(steps, hidden, batch, cuda))


@pytest.mark.parametrize('steps,hidden,batch,offset', [
    (4, 3, 37, 111),      # H * B odd, slabs at an odd offset (s[1:T] views)
    (9, 10, 4224, 2),     # H * B % 4 == 0 on 8-byte-aligned slabs: V = 1
])
def test_torch_cuda_jacobi_misaligned_views_match_plain(cuda, steps, hidden,
                                                        batch, offset):
    _jacobi_matches_plain(_jacobi_inputs(steps, hidden, batch, cuda, offset))


@pytest.mark.parametrize('steps,hidden,batch', [
    (9, 10, 4224), (9, 128, 2048), (13, 5, 1000), (9, 20, 2052)])
def test_torch_cuda_jacobi_instances_identical(cuda, steps, hidden, batch):
    """The float4 and the one-float instance run the same arithmetic on
    each element, so their outputs are bit for bit the same."""
    args = _jacobi_inputs(steps, hidden, batch, cuda)
    four = card_jacobi_plan(cuda, steps, hidden, batch, True)
    one = card_jacobi_plan(cuda, steps, hidden, batch, False)
    if four.vec != 4:     # too few items for a float4 wave: one block each
        items = steps * hidden * batch // 4
        four = JacobiPlan(4, 1, 128, -(-items // 128))
    assert (four.vec, one.vec) == (4, 1)
    got = jacobi_sweep(*args, plan=four)
    want = jacobi_sweep(*args, plan=one)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


def test_torch_cuda_jacobi_refuses_float4_on_misaligned_slabs(cuda):
    """A float4 plan on slabs that do not start on 16 bytes raises; the
    kernel never falls back to the plain version."""
    args = _jacobi_inputs(3, 4, 8, cuda, offset=1)
    with pytest.raises(RuntimeError):
        jacobi_sweep(*args, plan=JacobiPlan(4, 1, 128, 1))


def _spd(n, dim, seed, device):
    gen = torch.Generator().manual_seed(seed)
    m = torch.randn((n, dim, dim), generator=gen)
    a = m @ m.transpose(1, 2) + dim * torch.eye(dim)
    return a.to(device), torch.randn((n, dim), generator=gen).to(device)


# f32: the kernels (FMA, blocked order) and the plain versions (every
# product rounded, column order) differ by rounding, ~1e-7 on these SPD
# inputs (condition numbers below 5, solutions below 1 in magnitude).
CHOL_ATOL = 1e-5
# Widths at the edges of the warp kernel's buckets (8, 16, 32) and of the
# blocked kernels' 16-wide panels.
CHOL_DIMS = [1, 2, 15, 16, 17, 31, 32, 33, 47, 63, 64, 65, 100, 127, 128]
# N = 41 and 7 are not multiples of the warp kernel's 8 systems per block.
SOLVE_CASES = ([(40, 1), (40, 10), (512, 128), (37, 100), (3, 33)]
               + [(41, d) for d in CHOL_DIMS]
               + [(1, 10), (7, 10), (1, 100), (7, 64)])
INVERSE_CASES = ([(512, 64), (16, 128), (7, 33), (2, 1)]
                 + [(41, d) for d in CHOL_DIMS]
                 + [(1, 64), (7, 10), (1, 5)])


@pytest.mark.parametrize('n,dim', SOLVE_CASES)
def test_torch_cuda_chol_solve_matches_plain(cuda, n, dim):
    a, b = _spd(n, dim, seed=dim, device=cuda)
    before = chol_solve.launches
    got = chol_solve(a, b)
    torch.cuda.synchronize()
    assert chol_solve.launches == before + 1
    torch.testing.assert_close(got, chol_solve_plain(a, b), atol=CHOL_ATOL,
                               rtol=0)
    torch.testing.assert_close(got, torch.linalg.solve(a, b), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize('n,dim', INVERSE_CASES)
def test_torch_cuda_chol_inverse_matches_plain(cuda, n, dim):
    a, _ = _spd(n, dim, seed=dim + 1, device=cuda)
    before = chol_inverse.launches
    got = chol_inverse(a)
    torch.cuda.synchronize()
    assert chol_inverse.launches == before + 1
    torch.testing.assert_close(got, chol_inverse_plain(a), atol=CHOL_ATOL,
                               rtol=0)
    assert float(torch.triu(got, diagonal=1).abs().max()) == 0.0


@pytest.mark.parametrize('kappa', chip_smoke.ILL_KAPPAS)
@pytest.mark.parametrize('which,n,dim', [
    ('solve', 40, 10), ('solve', 40, 1), ('solve', 512, 128),
    ('solve', 41, 33), ('inverse', 512, 64), ('inverse', 41, 128),
    ('inverse', 41, 20)])
def test_torch_cuda_chol_ill_conditioned_gate(cuda, which, n, dim, kappa):
    """Gate (ii): on Gram-like inputs of condition number kappa, the
    kernel's error against float64 is at most ILL_REL times the plain
    version's plus ILL_ABS times the reference's max |x|."""
    a, b = chip_smoke.gram_inputs(n, dim, kappa, seed=dim)
    args = (a, b) if which == 'solve' else (a,)
    ref = chip_smoke.reference_f64(*args).to(cuda)
    args = tuple(t.to(cuda) for t in args)
    kernel, plain = ((chol_solve, chol_solve_plain) if which == 'solve'
                     else (chol_inverse, chol_inverse_plain))
    err = float((kernel(*args).double() - ref).abs().max())
    plain_err = float((plain(*args).double() - ref).abs().max())
    assert err <= (chip_smoke.ILL_REL * plain_err
                   + chip_smoke.ILL_ABS * float(ref.abs().max())), \
        (err, plain_err)


@pytest.mark.parametrize('which', ['solve', 'inverse'])
@pytest.mark.parametrize('dim', [10, 100])
def test_torch_cuda_chol_indefinite_system_is_nan_alone(cuda, which, dim):
    """An indefinite system gives NaN in its own result and leaves every
    other system of the launch as it was, bit for bit."""
    a, b = _spd(9, dim, seed=3, device=cuda)
    bad = a.clone()
    bad[4, dim // 2, dim // 2] = -1e4
    fn = (lambda m: chol_solve(m, b)) if which == 'solve' else chol_inverse
    good_out, bad_out = fn(a), fn(bad)
    assert bool(torch.isnan(bad_out[4]).any())
    others = [k for k in range(9) if k != 4]
    assert torch.equal(bad_out[others], good_out[others])


@pytest.mark.parametrize('which', ['solve', 'inverse'])
def test_torch_cuda_chol_reads_only_lower_triangle(cuda, which):
    """NaN above the diagonal changes nothing, bit for bit: the kernels
    load only the lower triangle of a."""
    a, b = _spd(9, 100, seed=5, device=cuda)
    poisoned = torch.where(
        torch.ones(100, 100, dtype=torch.bool, device=cuda).triu(1),
        torch.tensor(float('nan'), device=cuda), a)
    fn = (lambda m: chol_solve(m, b)) if which == 'solve' else chol_inverse
    assert torch.equal(fn(poisoned), fn(a))


@pytest.mark.parametrize('input_size', [2, 130])
def test_torch_cuda_turbo_step_kernels_match_plain(cuda, input_size):
    """Three turbo epochs with the kernels and with the plain versions on
    the card, at 'highest'; I = 130 takes the blocked solve."""
    tx, ty, _, _ = synth(batch=300, seq_len=6, input_size=input_size,
                         val_batch=4)
    x, y = torch.from_numpy(tx).to(cuda), torch.from_numpy(ty).to(cuda)
    params = init_lstm_params(torch.Generator().manual_seed(0), input_size,
                              7, 1, device=cuda)
    ps = parameter_set('Synthetic')
    states = {}
    for flag in (True, False):
        cfg = ADMMConfig.turbo(use_pallas_sweep=flag, use_pallas_chol=flag,
                               matmul_precision='highest')
        st = init_admm_state(params, x, ps, cfg)
        step = make_admm_step(cfg)
        before = (jacobi_sweep.launches, chol_solve.launches,
                  chol_inverse.launches)
        for _ in range(3):
            st = step(st, x, y)
        after = (jacobi_sweep.launches, chol_solve.launches,
                 chol_inverse.launches)
        if flag:
            assert after[0] - before[0] == 3
            assert after[1] - before[1] == (6 if input_size <= 128 else 3)
            assert after[2] - before[2] == (0 if input_size <= 128 else 9)
        else:
            assert after == before
        states[flag] = st
    for k in ('i', 'f', 'g', 'o', 'c', 'h'):
        np.testing.assert_allclose(
            getattr(states[True].gates, k).cpu().numpy(),
            getattr(states[False].gates, k).cpu().numpy(), atol=1e-4)
    for field in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(
            getattr(states[True].params, field).cpu().numpy(),
            getattr(states[False].params, field).cpu().numpy(), atol=1e-4)
