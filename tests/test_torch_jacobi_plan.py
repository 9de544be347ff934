"""The Jacobi kernel's launch plan (admm_lstm_torch.kernels.gate_sweep.
jacobi_plan), on the CPU: which vector width it takes, that the grid fills
the card in whole waves where the sweep is large enough, and, walking
every thread's items as csrc/gate_sweep.cu's jacobi_sweep_kernel does
(first item and stride divided into (step, offset) once, then added),
that every item of the sweep is taken exactly once, with the candidate
axis too."""

import numpy as np
import pytest
import torch

from admm_lstm_torch.kernels.gate_sweep import (JACOBI_THREADS, JacobiPlan,
                                                jacobi_plan, jacobi_sweep,
                                                jacobi_sweep_plain)

# Resident blocks per SM of the two kernel instances on an H100 (the CUDA
# runtime's occupancy at 128 threads: 164 and 64 registers a thread), and
# a smaller card's.
CARDS = {'h100': (132, {4: 3, 1: 8}), 'small': (20, {4: 2, 1: 5})}
SHAPES = [
    (1, 1, 1), (1, 3, 1), (2, 2, 2), (3, 1, 4),
    (13, 5, 1000),     # fills less than a wave at V = 4
    (5, 7, 1001),      # H * B odd
    (9, 10, 4224),     # GoogleStock
    (9, 20, 2052),     # several rounds, a partial last block
    (9, 128, 2048),    # the HAR-shaped turbo run
    (256, 16, 256),    # T = 512 time-sharded over two ranks: the first
    (255, 16, 256),    # block's interior rows and the last block's
    (9, 64, 2048),     # the HAR-shaped run's H block on two 'model' ranks
]


def _walk(plan, cands, steps, n):
    """How often each item (candidate, step, offset) is taken, and the
    most any thread takes, walking as the kernel does: the first item and
    the stride divided into (candidate, step, offset) once, then added
    with a carry from the offset into the step and from the step into the
    candidate."""
    lanes = plan.grid * plan.threads
    first = np.arange(lanes)
    row, o = first // n, first % n
    c, s = row // steps, row % steps
    drow, dof = divmod(lanes, n)
    dc, ds = divmod(drow, steps)
    seen = np.zeros(cands * steps * n, np.int64)
    taken = np.zeros(lanes, np.int64)
    live = c < cands
    while live.any():
        np.add.at(seen, (c[live] * steps + s[live]) * n + o[live], 1)
        taken += live
        c, s, o = c + dc, s + ds, o + dof
        wrap = o >= n
        s, o = s + wrap, o - wrap * n
        wrap = s >= steps
        c, s = c + wrap, s - wrap * steps
        live = c < cands
    return seen, int(taken.max())


@pytest.mark.parametrize('candidates', [1, 3])
@pytest.mark.parametrize('aligned', [True, False])
@pytest.mark.parametrize('card', sorted(CARDS))
@pytest.mark.parametrize('steps,hidden,batch', SHAPES)
def test_torch_jacobi_plan(steps, hidden, batch, card, aligned, candidates):
    """Every shape gets a plan, for one sweep and for three on the
    candidate axis; float4 only on aligned slabs of H * B % 4 == 0 whose
    items (every candidate's) fill a wave; one whole wave of resident
    blocks where the items fill it, else every block with an item; each
    item taken exactly once, no thread taking more than `per_thread`."""
    sms, blocks = CARDS[card]
    plan = jacobi_plan(steps, hidden, batch, sms, blocks, aligned,
                       candidates)
    slab = hidden * batch
    fills4 = (candidates * steps * slab // 4
              >= sms * blocks[4] * JACOBI_THREADS)
    assert plan.vec == (4 if aligned and slab % 4 == 0 and fills4 else 1)
    assert plan.threads == JACOBI_THREADS
    n = slab // plan.vec
    items = candidates * steps * n
    wave = sms * blocks[plan.vec]
    if items >= wave * plan.threads:
        assert plan.grid == wave and plan.grid % sms == 0
    else:
        assert plan.grid == -(-items // plan.threads)
    assert plan.per_thread == -(-items // (plan.grid * plan.threads))
    seen, most = _walk(plan, candidates, steps, n)
    assert (seen == 1).all()
    assert most == plan.per_thread


def test_torch_jacobi_plan_main_shapes():
    """On an H100: GoogleStock and the HAR-shaped run take float4s in one
    wave of 3 blocks an SM; (13, 5, 1000) too few items for a V = 4 wave,
    V = 1; an empty sweep or a card with no room raises."""
    sms, blocks = CARDS['h100']
    assert jacobi_plan(9, 10, 4224, sms, blocks, True) == JacobiPlan(
        4, 2, 128, 396)
    assert jacobi_plan(9, 128, 2048, sms, blocks, True) == JacobiPlan(
        4, 12, 128, 396)
    assert jacobi_plan(13, 5, 1000, sms, blocks, True).vec == 1
    with pytest.raises(ValueError):
        jacobi_plan(0, 10, 4224, sms, blocks, True)
    with pytest.raises(ValueError):
        jacobi_plan(9, 10, 4224, sms, {4: 0, 1: 8}, True)
    # The candidate axis: the rho grid and the scenario batch in one
    # launch; one candidate is the plan without the axis.
    assert jacobi_plan(9, 10, 4224, sms, blocks, True, 27) == JacobiPlan(
        4, 51, 128, 396)
    assert jacobi_plan(59, 10, 340, sms, blocks, True, 4).vec == 4
    assert jacobi_plan(9, 10, 4224, sms, blocks, True, 1) == jacobi_plan(
        9, 10, 4224, sms, blocks, True)
    with pytest.raises(ValueError, match='candidates'):
        jacobi_plan(9, 10, 4224, sms, blocks, True, 0)


def test_torch_jacobi_wrapper_cpu_ignores_plan():
    """On CPU tensors the wrapper runs the plain version whatever plan it
    is handed, and launches nothing."""
    rng = np.random.default_rng(6)
    slab = lambda: torch.from_numpy(
        rng.standard_normal((3, 4, 5)).astype(np.float32))
    pre = torch.from_numpy(
        rng.standard_normal((3, 4, 4, 5)).astype(np.float32))
    gates = tuple(slab() for _ in range(6))
    duals = tuple(slab() * 0.01 for _ in range(6))
    rho = torch.tensor([1., 1., 1., 1., 0.01, 0.001])
    args = (pre, gates, duals, slab(), slab(), rho)
    before = jacobi_sweep.launches
    got = jacobi_sweep(*args, plan=JacobiPlan(4, 1, 128, 1))
    want = jacobi_sweep_plain(*args)
    assert jacobi_sweep.launches == before
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
