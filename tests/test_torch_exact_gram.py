"""The exact stage's Gram kernel's Python side on the CPU
(admm_lstm_torch/kernels/exact_gram.py): the plain version against the
exact stage's activation lines and Gram routes as they are written out
here, the dispatch (the CPU and 'default' keep the plain routes), and the
plans the kernel is launched with.  The kernel itself runs on the card
only (tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from admm_lstm_torch.core.step import gate_is_tanh
from admm_lstm_torch.kernels import exact_gram as eg
from admm_lstm_torch.solvers import normal_eq as ne

torch.set_num_threads(1)

# f32 sums of T * B products taken in another order; relative to the
# outputs' scale.
RTOL, ATOL = 1e-5, 1e-5


def _inputs(cands, steps, hidden, dim, batch, shared, seed):
    """Seeded ([S,] T, 4H, B) pre-activations and targets near act(pre),
    and a (T, D, B) design shared by the candidates or (S, T, D, B)."""
    gen = torch.Generator().manual_seed(seed)
    lead = (cands,)
    pre = torch.randn(lead + (steps, 4 * hidden, batch), generator=gen)
    tanh_cols = gate_is_tanh(4 * hidden, hidden, 'cpu')
    act = torch.where(tanh_cols[:, None], torch.tanh(pre),
                      torch.sigmoid(pre))
    target = act + 0.05 * torch.randn(pre.shape, generator=gen)
    m_lead = () if shared else lead
    m_inputs = 0.5 * torch.randn(m_lead + (steps, dim, batch), generator=gen)
    return m_inputs, pre, target, tanh_cols


def _activation_lines(pre, target_w, tanh_cols):
    """The exact stage's activation lines: u = tanh(s x), act = a + s u,
    act' = c (1 - u^2) with each column's constants, then s2 = act'^2 and
    wres = act' (act - target)."""
    dtype = pre.dtype
    tanh_b = tanh_cols[:, None]
    s_cols = torch.where(tanh_b, 1.0, 0.5).to(dtype)
    u = torch.tanh(s_cols * pre)
    act = torch.where(tanh_b, 0.0, 0.5).to(dtype) + s_cols * u
    d_act = torch.where(tanh_b, 1.0, 0.25).to(dtype) * (1.0 - u * u)
    resid = act - target_w
    return d_act * d_act, d_act * resid


CASES = [(2, 5, 2, 1, 37, True), (3, 4, 3, 5, 64, False),
         (2, 7, 2, 8, 5, True), (3, 3, 4, 8, 48, False)]


@pytest.mark.parametrize('strategy', ne.GRAM_STRATEGIES)
@pytest.mark.parametrize('case', CASES)
def test_torch_exact_gram_plain_is_the_stage_arithmetic(strategy, case):
    """exact_gram_plain at 'highest' against the activation lines and
    normal_eq._gram_bvec with the same strategy forced: S 2-3, K = 4H
    with tanh and sigmoid columns, D 1, 5 and 8, a shared design and one
    per candidate."""
    m_inputs, pre, target, tanh_cols = _inputs(*case, seed=sum(case))
    s2, wres = _activation_lines(pre, target, tanh_cols)
    want = ne._gram_bvec(s2, wres, m_inputs, 'highest', strategy=strategy)
    got = eg.exact_gram_plain(m_inputs, pre, target, tanh_cols, 'highest',
                              strategy=strategy)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize('case', CASES)
def test_torch_exact_gram_on_the_cpu_is_the_plain_version(case):
    """exact_gram on CPU tensors runs the plain version (bit for bit) and
    launches nothing; activation_terms are the activation lines."""
    m_inputs, pre, target, tanh_cols = _inputs(*case, seed=7)
    before = eg.exact_gram.launches
    got = eg.exact_gram(m_inputs, pre, target, tanh_cols)
    want = eg.exact_gram_plain(m_inputs, pre, target, tanh_cols)
    assert eg.exact_gram.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    terms = eg.activation_terms(pre, target, tanh_cols)
    assert all(torch.equal(a, b) for a, b in zip(
        terms, _activation_lines(pre, target, tanh_cols)))


@pytest.mark.parametrize('device, precision, dim, takes', [
    ('cuda', 'highest', 1, True), ('cuda', 'highest', 40, True),
    ('cuda', 'highest', eg.MAX_DIM, True),
    ('cuda', 'highest', eg.MAX_DIM + 1, False),
    ('cuda', 'default', 40, False), ('cuda', 'high', 40, False),
    ('cpu', 'highest', 40, False)])
def test_torch_exact_gram_dispatch(device, precision, dim, takes):
    """The kernel takes CUDA tensors at 'highest' up to MAX_DIM design
    columns; the CPU, 'default' (the bf16 operand rounding), 'high' (the
    TF32 control) and wider designs keep the plain routes."""
    assert eg.use_gram_kernel(device, precision, dim) is takes


@pytest.mark.parametrize('precision', ['highest', 'default'])
def test_torch_exact_stage_on_the_cpu_keeps_the_plain_routes(precision):
    """gauss_newton_ridge_update_wide on CPU tensors launches nothing and
    equals the stage written with the activation lines and the strategy
    its shape picks."""
    m_inputs, pre, target, tanh_cols = _inputs(3, 4, 2, 5, 20, False, 11)
    gen = torch.Generator().manual_seed(12)
    w = 0.3 * torch.randn((3, 5, 8), generator=gen)
    rho = torch.rand((3, 4), generator=gen) + 0.5
    beta = torch.full((3, 4), 1e-3)
    before = eg.exact_gram.launches
    got = ne.gauss_newton_ridge_update_wide(m_inputs, pre, w, target, rho,
                                            beta, tanh_cols, precision)
    assert eg.exact_gram.launches == before
    strategy = ne._gram_strategy(8, 5, 4 * 20)
    s2, wres = _activation_lines(pre, target, tanh_cols)
    gram, bvec = ne._gram_bvec(s2, wres, m_inputs, precision,
                               strategy=strategy)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ne, 'exact_gram_plain', lambda *a, **k: (gram, bvec))
        want = ne.gauss_newton_ridge_update_wide(m_inputs, pre, w, target,
                                                 rho, beta, tanh_cols,
                                                 precision)
    assert torch.equal(got, want)


@pytest.mark.parametrize('n_cols', [4, 8, 12, 40, 160, 320, 512])
def test_torch_exact_gram_plans_fit_the_kernel(n_cols):
    """Every D from 1 to MAX_DIM has a plan the kernel takes
    (csrc/exact_gram.cu's launch checks): at most 384 threads, a full
    warp for each row group (two quads of the chunk's rows) and for each
    MAX_PF design rows, every column made by a thread, the chunk groups
    dividing 32,
    the tiles covering K and the packed columns, the parts every chunk
    once; the plan names no candidate count."""
    for dim in range(1, eg.MAX_DIM + 1):
        for steps, batch in ((10, 4224), (3, 5), (1, 1)):
            plan = eg.gram_plan(n_cols, dim, steps, batch)
            threads = plan.threads
            assert threads <= eg.MAX_THREADS
            assert threads // 32 >= plan.rows
            assert threads // 32 * eg.MAX_PF >= dim
            assert threads >= 8 * plan.cols
            assert eg.CHUNK % plan.groups == 0
            assert 8 * plan.rows * -(-n_cols // (8 * plan.rows)) >= n_cols
            total = steps * -(-batch // eg.CHUNK)
            assert (plan.parts * plan.chunks_per_part >= total
                    > (plan.parts - 1) * plan.chunks_per_part)
    with pytest.raises(ValueError):
        eg.gram_plan(n_cols, eg.MAX_DIM + 1, 10, 4224)


def test_torch_exact_gram_packed_columns():
    """The pairs d <= e and the D bvec columns, each padded to 8: 864 at
    the stacked cell's h side (D 40), 16 at its x side (D 1)."""
    assert eg.packed_columns(40) == 824 + 40
    assert eg.packed_columns(1) == 16
    assert eg.packed_columns(10) == 56 + 16
