"""Tests of the port's CUDA kernels (the Gauss-Seidel and Jacobi sweeps,
both with the candidate axis too, the serial-floor probe,
the batched Cholesky solve and inverse), of the rho search's batched
program, of the
legacy variants' epochs, of data-parallel ranks (gloo ranks sharing the
card, one NCCL rank) and of the scenario batch on the card; they need a
CUDA card and skip without one.  This file imports no JAX, so it also
runs where JAX is not installed:

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
                                                card_floor_plan,
                                                card_jacobi_plan,
                                                card_sweep_plan,
                                                floor_sweep,
                                                floor_sweep_plain,
                                                floor_sweep_plan,
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
    (59, 10, 340),     # a YahooFinance scenario (4 folds)
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
    before = (interior_sweep.launches, interior_sweep.candidate_launches)
    got = interior_sweep(*args)
    torch.cuda.synchronize()
    assert (interior_sweep.launches,
            interior_sweep.candidate_launches) == (before[0] + 1, before[1])
    want = interior_sweep_plain(*args)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


BATCHED_SHAPES = [
    (3, 9, 10, 100),
    (27, 9, 10, 4224),   # the GoogleStock rho grid
    (4, 59, 10, 340),    # the YahooFinance scenario batch
    (2, 5, 40, 33),      # two rows a thread, padded wh, ragged B
    (3, 4, 130, 64),     # wh streamed
    (1, 6, 7, 50),       # one candidate on the axis
]


@pytest.mark.parametrize('cands,steps,hidden,batch', BATCHED_SHAPES)
def test_torch_cuda_batched_sweep_matches_plain(cuda, cands, steps, hidden,
                                                batch):
    """The kernel with the candidate axis, one launch for all S, against
    its plain version (each candidate's plain sweep)."""
    args = chip_smoke.candidate_inputs(cands, steps, hidden, batch, 3)
    before = (interior_sweep.launches, interior_sweep.candidate_launches)
    got = interior_sweep(*args)
    torch.cuda.synchronize()
    assert (interior_sweep.launches,
            interior_sweep.candidate_launches) == (before[0] + 1,
                                                   before[1] + 1)
    want = interior_sweep_plain(*args)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.shape == (cands, steps, hidden, batch)
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize('cands,steps,hidden,batch', BATCHED_SHAPES)
def test_torch_cuda_batched_sweep_matches_launches_alone(cuda, cands, steps,
                                                         hidden, batch):
    """One launch with the axis against S launches without it: bit-equal
    where the candidate's plan takes the same tiles and rows (the same
    sums in the same order), within ATOL where it does not."""
    args = chip_smoke.candidate_inputs(cands, steps, hidden, batch, 5)
    got = interior_sweep(*args)
    plan = card_sweep_plan(cuda, hidden, batch, cands)
    alone_plan = card_sweep_plan(cuda, hidden, batch)
    same = plan._replace(grid=0) == alone_plan._replace(grid=0)
    xproj, wh, gates, duals, rho = args
    for s in range(cands):
        want = interior_sweep(xproj[s].contiguous(), wh[s],
                              tuple(g[s].contiguous() for g in gates),
                              tuple(d[s].contiguous() for d in duals), rho[s])
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            if same:
                assert torch.equal(a[s], b), s
            else:
                torch.testing.assert_close(a[s], b, atol=ATOL, rtol=0)


def test_torch_cuda_batched_search_rho_matches_cpu(cuda):
    """tune.search_rho on the card, one batched program (one interior
    sweep launch an epoch for the whole grid), against the same search on
    the CPU."""
    from admm_lstm_torch import tune
    tx, ty, vx, vy = synth(batch=200, seq_len=8, input_size=1,
                           output_size=1, val_batch=40, seed=4)
    params = init_lstm_params(torch.Generator().manual_seed(1), 1, 6, 1)
    ps = parameter_set('Synthetic')
    cpu = tune.search_rho(tx, ty, vx, vy, ps, ADMMConfig(hidden_size=6),
                          epochs=4, params=params, device='cpu')
    before = (interior_sweep.launches, interior_sweep.candidate_launches)
    got = tune.search_rho(tx, ty, vx, vy, ps, ADMMConfig(hidden_size=6),
                          epochs=4, params=params, device='cuda')
    assert (interior_sweep.launches - before[0],
            interior_sweep.candidate_launches - before[1]) == (4, 4)
    np.testing.assert_allclose(got['val_losses'], cpu['val_losses'],
                               rtol=1e-4)
    assert got['best_rho'] == cpu['best_rho']


@pytest.mark.parametrize('config', ['turbo', 'auto'])
def test_torch_cuda_batched_turbo_search_rho_matches_cpu(cuda, config):
    """tune.search_rho under turbo() and auto() at 'highest' on the card,
    one batched program (one jacobi_sweep launch with the axis and two
    chol_solve an epoch for the whole grid), against the same search on
    the CPU."""
    from admm_lstm_torch import tune
    tx, ty, vx, vy = synth(batch=200, seq_len=8, input_size=1,
                           output_size=1, val_batch=40, seed=4)
    params = init_lstm_params(torch.Generator().manual_seed(1), 1, 6, 1)
    ps = parameter_set('Synthetic')
    cfg = getattr(ADMMConfig, config)(hidden_size=6,
                                      matmul_precision='highest')
    cpu = tune.search_rho(tx, ty, vx, vy, ps, cfg, epochs=4, params=params,
                          device='cpu')
    before = (jacobi_sweep.launches, jacobi_sweep.candidate_launches,
              chol_solve.launches, interior_sweep.launches)
    got = tune.search_rho(tx, ty, vx, vy, ps, cfg, epochs=4, params=params,
                          device='cuda')
    assert (jacobi_sweep.launches - before[0],
            jacobi_sweep.candidate_launches - before[1],
            chol_solve.launches - before[2],
            interior_sweep.launches - before[3]) == (4, 4, 8, 0)
    np.testing.assert_allclose(got['val_losses'], cpu['val_losses'],
                               rtol=1e-4)
    assert got['best_rho'] == cpu['best_rho']


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


@pytest.mark.parametrize('steps,hidden,batch', chip_smoke.FLOOR_SHAPES)
def test_torch_cuda_floor_matches_plain(cuda, steps, hidden, batch):
    """chip_smoke.py's [floor] shapes: the probe's default, (127, 16,
    512), GoogleStock's, wh streamed, the routes' edge (H 32 and 33), a
    ragged batch edge, small ones; one launch counted per call."""
    xproj, wh = chip_smoke.floor_inputs(steps, hidden, batch, seed=steps)
    before = floor_sweep.launches
    got = floor_sweep(xproj, wh)
    assert floor_sweep.launches == before + 1
    want = floor_sweep_plain(xproj, wh)
    torch.cuda.synchronize()
    assert floor_sweep.launches == before + 1
    assert got.shape == (steps, hidden, batch)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize('steps,hidden,batch', [
    (33, 1, 70),       # one lane a column, 32 columns a warp
    (40, 2, 33),
    (17, 4, 9),
    (65, 17, 300),     # 32 lanes, wh in shared memory, several warps a block
    (9, 10, 4224),
])
def test_torch_cuda_floor_warp_widths(cuda, steps, hidden, batch):
    """Every lane width of the warp-synchronous kernel, and its route
    against the recurrence on interior_sweep's tile plan."""
    plan = card_floor_plan(cuda, hidden, batch)
    assert plan.route == 'warp'
    xproj, wh = chip_smoke.floor_inputs(steps, hidden, batch, seed=hidden)
    want = floor_sweep_plain(xproj, wh)
    onplan = floor_sweep_plan(card_sweep_plan(cuda, hidden, batch))
    for p in (plan, onplan):
        before = floor_sweep.launches
        got = floor_sweep(xproj, wh, plan=p)
        torch.cuda.synchronize()
        assert floor_sweep.launches == before + 1
        assert float((got - want).abs().max()) <= ATOL


def test_torch_cuda_floor_refuses_a_wrong_plan(cuda):
    """A plan the kernel does not take raises: no fallback, no launch."""
    xproj, wh = chip_smoke.floor_inputs(5, 16, 64, seed=0)
    plan = card_floor_plan(cuda, 16, 64)
    before = floor_sweep.launches
    for bad in (plan._replace(lanes=32), plan._replace(grid=plan.grid - 1),
                plan._replace(warps=8), plan._replace(smem=512)):
        with pytest.raises(RuntimeError):
            floor_sweep(xproj, wh, plan=bad)
    assert floor_sweep.launches == before


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
    (256, 16, 256),    # time-sharded T = 512: the first block's interior
    (255, 16, 256),    # and the last block's (parallel/sharding.py)
    (9, 64, 2048),     # HAR-shaped turbo, H = 128 on two 'model' ranks
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


JACOBI_BATCHED_SHAPES = [
    (27, 9, 10, 4224),   # the GoogleStock rho grid under auto()
    (4, 59, 10, 340),    # the scenario batch under turbo()
    (3, 9, 128, 2048),   # Path B's three candidates
    (3, 5, 7, 1001),     # H * B odd: one float at a time
    (2, 4, 3, 37),       # fewer items than a block
    (1, 6, 7, 52),       # one candidate on the axis
]


@pytest.mark.parametrize('cands,steps,hidden,batch', JACOBI_BATCHED_SHAPES)
def test_torch_cuda_batched_jacobi_matches_plain(cuda, cands, steps, hidden,
                                                 batch):
    """The Jacobi kernel with the candidate axis, one launch for all S on
    slabs sliced as the epoch slices the state's, against its plain
    version."""
    args = chip_smoke.jacobi_candidate_inputs(cands, steps, hidden, batch, 3)
    before = (jacobi_sweep.launches, jacobi_sweep.candidate_launches)
    got = jacobi_sweep(*args)
    torch.cuda.synchronize()
    assert (jacobi_sweep.launches,
            jacobi_sweep.candidate_launches) == (before[0] + 1, before[1] + 1)
    want = jacobi_sweep_plain(*args)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.shape == (cands, steps, hidden, batch)
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize('cands,steps,hidden,batch', JACOBI_BATCHED_SHAPES)
def test_torch_cuda_batched_jacobi_matches_launches_alone(cuda, cands, steps,
                                                          hidden, batch):
    """One launch with the axis against S launches without it: bit-equal,
    since every element runs the same arithmetic in either float width
    (test_torch_cuda_jacobi_instances_identical)."""
    args = chip_smoke.jacobi_candidate_inputs(cands, steps, hidden, batch, 5)
    got = jacobi_sweep(*args)
    pre, gates, duals, h_prev, c_prev, rho = args
    for s in range(cands):
        want = jacobi_sweep(pre[s], tuple(g[s].contiguous() for g in gates),
                            tuple(d[s].contiguous() for d in duals),
                            h_prev[s].contiguous(), c_prev[s].contiguous(),
                            rho[s])
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(a[s], b), s


def test_torch_cuda_batched_jacobi_refuses_float4_on_odd_strides(cuda):
    """A float4 plan on candidates whose slabs start an odd number of
    floats apart raises; the kernel never falls back."""
    pre, gates, duals, h_prev, c_prev, rho = (
        chip_smoke.jacobi_candidate_inputs(2, 3, 4, 8, 1))

    def odd(t):                 # 16-byte aligned, 97 floats apart
        full = torch.zeros((2, 3 * 32 + 1), device=cuda)
        view = full[:, :96].view(2, 3, 4, 8)
        view.copy_(t)
        return view

    with pytest.raises(RuntimeError):
        jacobi_sweep(pre, tuple(map(odd, gates)), tuple(map(odd, duals)),
                     odd(h_prev), odd(c_prev), rho,
                     plan=JacobiPlan(4, 1, 128, 1))


@pytest.mark.parametrize('which,cands,n,dim', [
    ('solve', 27, 40, 10),     # the auto() rho grid's h stage
    ('solve', 27, 40, 1),      # and its x stage
    ('solve', 3, 512, 128),
    ('inverse', 3, 512, 64),   # Path B's three candidates' blocks
    ('inverse', 2, 7, 33)])
def test_torch_cuda_batched_chol_matches_calls_alone(cuda, which, cands, n,
                                                     dim):
    """One call on S x N systems (the candidates' systems folded into N,
    as the exact stage folds them) against S calls on N alone:
    bit-equal, each system runs in a warp or a block of its own."""
    a, b = _spd(cands * n, dim, seed=dim + 3, device=cuda)
    if which == 'solve':
        got = chol_solve(a, b)
        want = [chol_solve(a[s * n:(s + 1) * n], b[s * n:(s + 1) * n])
                for s in range(cands)]
    else:
        got = chol_inverse(a)
        want = [chol_inverse(a[s * n:(s + 1) * n]) for s in range(cands)]
    assert torch.equal(got, torch.cat(want))


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
SOLVE_CASES = ([(40, 1), (40, 10), (512, 128), (37, 100), (3, 33),
                (256, 128)]     # HAR's h-stage on two 'model' ranks
               + [(41, d) for d in CHOL_DIMS]
               + [(1, 10), (7, 10), (1, 100), (7, 64)])
INVERSE_CASES = ([(512, 64), (16, 128), (7, 33), (2, 1),
                  (256, 64)]    # HAR's x-stage blocks on two 'model' ranks
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


@pytest.mark.parametrize('hiddens', [(6, 5), (6, 5, 4)])
def test_torch_cuda_stacked_step_kernels_match_plain(cuda, hiddens):
    """Three stacked epochs with chol_solve and with its plain version on
    the card, at 'highest': two launches an epoch (layer 0's x and h
    stages), the states within 1e-4."""
    from admm_lstm_torch.variants import stacked
    tx, ty, _, _ = synth(batch=300, seq_len=6, input_size=2, val_batch=4)
    x, y = torch.from_numpy(tx).to(cuda), torch.from_numpy(ty).to(cuda)
    params = stacked.init_stacked(torch.Generator().manual_seed(0), 2,
                                  hiddens, 1, device=cuda)
    ps = parameter_set('Stacked')
    states = {}
    for flag in (True, False):
        cfg = ADMMConfig(use_pallas_chol=flag)
        st = stacked.init_stacked_state(params, x, ps, cfg)
        step = stacked.make_stacked_step(cfg)
        before = chol_solve.launches
        for _ in range(3):
            st = step(st, x, y)
        assert chol_solve.launches - before == (6 if flag else 0)
        states[flag] = st
    got, ref = states[True], states[False]
    for a, b in zip(got.params.tensors(), ref.params.tensors()):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4)
    for k in range(len(hiddens)):
        for f in ('i', 'f', 'g', 'o', 'c', 'h', 'a'):
            np.testing.assert_allclose(
                getattr(got.gates[k], f).cpu().numpy(),
                getattr(ref.gates[k], f).cpu().numpy(), atol=1e-4)
    for a, b in zip(got.zs, ref.zs):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4)


def test_torch_cuda_legacy_epochs_match_cpu(cuda):
    """One ADMM-LSTM-L and one ADMM-LSTM-S epoch on the card against the
    same epoch of the CPU port, from the state two card epochs reach:
    each leaf within chip_smoke.LEGACY_RTOL of its scale (chip_smoke.py's
    legacy item 6, on a small synthetic problem)."""
    tx, ty, _, _ = synth(batch=256, seq_len=6, input_size=2, output_size=1,
                         val_batch=8)
    assert chip_smoke._legacy_epoch_vs_cpu(tx, ty) <= 1.0


def _sharded_cases(cfg, tx, ty, vx, vy, params):
    """`parallel/launch.run_cases`'s one call of api.train_sharded."""
    from admm_lstm_torch import api
    return [(api.train_sharded,
             dict(train_x=tx, train_y=ty, val_x=vx, val_y=vy,
                  parameter_set=parameter_set('Synthetic'), config=cfg,
                  params=params, log_every=0, device='cuda'))]


@pytest.mark.parametrize('sweep_mode', ['gauss_seidel', 'jacobi'])
def test_torch_cuda_gloo_ranks_sharing_the_card_match_one_process(
        cuda, sweep_mode, tmp_path):
    """Two gloo ranks on the one card, each running the sweep kernel on
    its block of the batch, against the single-process kernel run (the
    counterpart of test_sharding.py::test_dp_pallas_sweep_matches_
    unsharded); the ranks' weights bit-equal."""
    from admm_lstm_torch import api
    from admm_lstm_torch.kernels import build
    from admm_lstm_torch.parallel.launch import run_cases, spawn
    build.build_all(['gate_sweep', 'cholesky'])   # once, before the ranks
    tx, ty, vx, vy = synth(batch=256, seq_len=20, input_size=2,
                           output_size=1, val_batch=32)
    params = init_lstm_params(torch.Generator().manual_seed(0), 2, 8, 1)
    cfg = ADMMConfig(hidden_size=8, epochs=3, use_pallas_sweep=True,
                     sweep_mode=sweep_mode)
    ref = api.train(tx, ty, vx, vy, parameter_set('Synthetic'), cfg,
                    params=params, log_every=0, device='cuda')
    r0, r1 = (r[0] for r in spawn(
        run_cases, 2, args=(_sharded_cases(cfg.replace(mesh_shape=(2,)),
                                             tx, ty, vx, vy, params),),
        backend='gloo', timeout=300, workdir=str(tmp_path)))
    for a, b, want in zip(r0['params'], r1['params'], ref['params']):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), want.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(r0['state'].gates.h.numpy(),
                               ref['state'].gates.h.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(r0['val_loss'], ref['val_loss'], rtol=1e-5)


@pytest.mark.parametrize('layout', ['time', 'model'])
def test_torch_cuda_layouts_on_gloo_ranks_match_one_process(cuda, layout,
                                                            tmp_path):
    """Two gloo ranks on the one card under the time-sharded layout (the
    Jacobi kernel on each time block) and under tensor parallelism (the
    Gauss-Seidel kernel on the slabs gathered to the whole H), against
    the single-process kernel run."""
    from admm_lstm_torch import api
    from admm_lstm_torch.kernels import build
    from admm_lstm_torch.parallel.launch import run_cases, run_layout, spawn
    build.build_all(['gate_sweep', 'cholesky'])   # once, before the ranks
    tx, ty, vx, vy = synth(batch=256, seq_len=21, input_size=2,
                           output_size=1, val_batch=32)
    params = init_lstm_params(torch.Generator().manual_seed(0), 2, 8, 1)
    time_sharded = layout == 'time'
    cfg = ADMMConfig(hidden_size=8, epochs=3, use_pallas_sweep=True,
                     sweep_mode='jacobi' if time_sharded else 'gauss_seidel')
    ref = api.train(tx, ty, vx, vy, parameter_set('Synthetic'), cfg,
                    params=params, log_every=0, device='cuda')
    case = dict(mesh_shape=(2,) if time_sharded else (1, 2),
                axis_names=('data',) if time_sharded else ('data', 'model'),
                shard_time=time_sharded,
                model_axis=None if time_sharded else 'model', config=cfg,
                parameter_set=parameter_set('Synthetic'), params=params,
                data=(tx, ty, vx, vy), epochs=3, device='cuda')
    r0, r1 = (r[0] for r in spawn(run_cases, 2, args=([(run_layout, case)],),
                                  backend='gloo', timeout=300,
                                  workdir=str(tmp_path)))
    for a, b, want in zip(r0['state'].params, r1['state'].params,
                          ref['params']):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), want.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(r0['state'].gates.h.numpy(),
                               ref['state'].gates.h.cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(r0['val_loss'], ref['val_loss'][1:],
                               rtol=1e-5)


def test_torch_cuda_nccl_one_rank_is_bit_equal_to_train(cuda, tmp_path):
    """One NCCL rank: the consensus is the identity, so the run is
    api.train's bit for bit."""
    from admm_lstm_torch import api
    from admm_lstm_torch.parallel.launch import run_cases, spawn
    tx, ty, vx, vy = synth(batch=256, seq_len=10, input_size=2,
                           output_size=1, val_batch=32)
    params = init_lstm_params(torch.Generator().manual_seed(0), 2, 8, 1)
    cfg = ADMMConfig(hidden_size=8, epochs=3)
    ref = api.train(tx, ty, vx, vy, parameter_set('Synthetic'), cfg,
                    params=params, log_every=0, device='cuda')
    (got,), = spawn(run_cases, 1, args=(_sharded_cases(
        cfg.replace(mesh_shape=(1,)), tx, ty, vx, vy, params),),
        backend='nccl', timeout=300, workdir=str(tmp_path))
    assert got['mesh']['backend'] == 'nccl'
    assert got['val_loss'] == ref['val_loss']
    assert got['train_loss'] == ref['train_loss']
    for a, b in zip(got['params'], ref['params']):
        assert torch.equal(a, b.cpu())


def test_torch_cuda_nccl_refuses_ranks_sharing_a_card(cuda, tmp_path):
    """The backend rule: NCCL only when each rank has a card of its own;
    ranks that would share one must ask for gloo, and the error says so,
    both before the ranks start (backend_for) and in a rank (make_mesh)."""
    from admm_lstm_torch.parallel import backend_for
    from admm_lstm_torch.parallel.launch import run_cases, spawn
    cards = torch.cuda.device_count()
    assert backend_for('cuda', cards) == 'nccl'
    assert backend_for('cuda', cards + 1, 'gloo') == 'gloo'
    with pytest.raises(ValueError, match='gloo'):
        backend_for('cuda', cards + 1)
    if cards > 1:
        pytest.skip('the in-rank check needs ranks sharing one card')
    tx, ty, vx, vy = synth(batch=16, seq_len=3, input_size=2, output_size=1,
                           val_batch=4)
    params = init_lstm_params(torch.Generator().manual_seed(0), 2, 4, 1)
    cfg = ADMMConfig(hidden_size=4, epochs=1, mesh_shape=(2,))
    with pytest.raises(RuntimeError, match='gloo'):
        spawn(run_cases, 2, args=(_sharded_cases(cfg, tx, ty, vx, vy,
                                                   params),),
              backend='nccl', timeout=120, workdir=str(tmp_path))


def test_torch_cuda_train_scenarios_matches_cpu(cuda):
    """api.train_scenarios on the card (one batched program: one sweep
    kernel launch an epoch for every scenario) against the same run on
    the CPU (the plain loop), 3 Synthetic scenarios x 3 epochs."""
    from admm_lstm_torch import api
    from admm_lstm_torch.kernels import gate_sweep
    scen = [synth(batch=64, seq_len=12, input_size=1, output_size=1,
                  val_batch=16, seed=s) for s in range(3)]
    data = tuple(np.stack([s[k] for s in scen]) for k in range(4))
    cfg = ADMMConfig(hidden_size=6, epochs=3, wy_lipschitz=True)
    ps = parameter_set('Synthetic')
    cpu = api.train_scenarios(*data, ps, cfg, device='cpu')
    gate_sweep.interior_sweep.launches = 0
    # The default inits come from CPU generators: the same on both.
    got = api.train_scenarios(*data, ps, cfg, device='cuda')
    assert gate_sweep.interior_sweep.launches == 3
    np.testing.assert_allclose(got['train_loss'], cpu['train_loss'],
                               rtol=1e-5)
    np.testing.assert_allclose(got['val_loss'], cpu['val_loss'], rtol=1e-5)
    for a, b in zip(got['params'], cpu['params']):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=ATOL)
