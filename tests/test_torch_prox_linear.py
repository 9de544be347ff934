"""The port's line-search solvers (admm_lstm_torch.solvers.prox_linear)
against the JAX package's, on the same random numpy inputs: weights and
h at 1e-5, theta and iteration counts equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from admm_lstm_tpu.solvers import prox_linear as jpl
from admm_lstm_torch.solvers import prox_linear as tpl

torch.set_num_threads(1)

ATOL = 1e-5


def _stage_inputs(seed, seq_len, d, hidden, batch, rho_g, m_scale, eps):
    """Targets within `eps` of the current activations: a near-stationary
    point, where the searches have to double theta (up to 17 times for
    the largest rho below)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    m = f32(rng.standard_normal((seq_len, d, batch)) * m_scale)
    w = f32(rng.standard_normal((d, 4 * hidden)) * 0.2)
    proj_self = f32(np.einsum('tdb,dk->tkb', m, w))
    proj_other = f32(rng.standard_normal((seq_len, 4 * hidden, batch)) * 0.3)
    tanh_cols = np.repeat(np.asarray([False, False, True, False]), hidden)
    pre = proj_self + proj_other
    act = np.where(tanh_cols[:, None], np.tanh(pre), 1 / (1 + np.exp(-pre)))
    target = f32(act + eps * rng.standard_normal(act.shape))
    beta = f32(np.full(4, 8e-7))
    return m, proj_self, proj_other, w, target, f32(rho_g), beta, tanh_cols


@pytest.mark.parametrize('rho_g,m_scale,eps,max_iters', [
    ([1., 1., 1., 1.], 0.3, 0.1, 60),          # one block
    ([0.01, 1., 100., 1e4], 3.0, 1e-3, 60),    # three blocks of candidates
    ([0.01, 1., 100., 1e4], 3.0, 1e-3, 11),    # the doubling cap binds
    ([1., 1., 1., 1.], 0.3, 0.1, 0),           # no search at all
])
def test_torch_weight_stage_matches_jax(rho_g, m_scale, eps, max_iters):
    seq_len, d, hidden, batch = 5, 3, 4, 40
    args = _stage_inputs(1, seq_len, d, hidden, batch, rho_g, m_scale, eps)
    ref = jpl.weight_stage_update_wide(
        *(jnp.asarray(a) for a in args), seq_len, max_iters,
        lax.Precision.HIGHEST)
    got = tpl.weight_stage_update_wide(
        *(torch.from_numpy(a) for a in args), seq_len, max_iters)
    np.testing.assert_array_equal(got.theta.numpy(), np.asarray(ref.theta))
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               atol=ATOL)
    np.testing.assert_allclose(got.proj_new.numpy(), np.asarray(ref.proj_new),
                               atol=ATOL)


FLAVOURS = {
    'fast': dict(with_dual_y=False),
    'dual_y': dict(with_dual_y=True),
    'no_dual_y': dict(with_dual_y=False, grad_uses_rho_h=True,
                      probe_is_grad_over_theta=True),
}


@pytest.mark.parametrize('flavour', sorted(FLAVOURS))
@pytest.mark.parametrize('rho_y', [5.6e-5, 3.0])
def test_torch_h_final_matches_jax(flavour, rho_y):
    rng = np.random.default_rng(7)
    batch, hidden, out = 32, 6, 2
    f32 = lambda a: np.asarray(a, np.float32)
    arrays = dict(
        h_old=f32(rng.standard_normal((batch, hidden)) * 0.5),
        o_new=f32(rng.uniform(0, 1, (batch, hidden))),
        tanh_c_new=f32(np.tanh(rng.standard_normal((batch, hidden)))),
        lam_h=f32(rng.standard_normal((batch, hidden)) * 0.01),
        rho_h=f32(0.00045),
        wy=f32(rng.standard_normal((hidden, out))),
        a_old=f32(rng.standard_normal((batch, out))),
        rho_y=f32(rho_y),
        lam_y=f32(rng.standard_normal((batch, out)) * 0.01))
    kw = dict(FLAVOURS[flavour], theta0=0.1, theta_max=1.0, max_iters=60)
    ref = jpl.h_final_update(**{k: jnp.asarray(v) for k, v in arrays.items()},
                             precision=lax.Precision.HIGHEST, **kw)
    got = tpl.h_final_update(**{k: torch.from_numpy(v)
                                for k, v in arrays.items()}, **kw)
    assert float(got.theta) == float(ref.theta)
    # theta ends at theta0 * 2^iters / 2: the JAX loop's iteration count.
    assert got.iters == round(np.log2(float(ref.theta) * 2 / 0.1))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h), atol=ATOL)


def _loop_sums(pre, grad_proj, target_w, cands, tanh_cols):
    """The weight stage's theta tests as the stage's own loop computed
    them: per theta, act(pre + grad_proj / theta) - target_w over the
    whole slabs, squared and summed per gate."""
    hidden = pre.shape[-2] // 4
    tanh_b = tanh_cols[:, None]
    one, half = torch.tensor(1.0), torch.tensor(0.5)
    s_cols = b_cols = torch.where(tanh_b, one, half)
    a_cols = torch.where(tanh_b, torch.tensor(0.0), half)
    per_gate = lambda v: v.reshape(v.shape[:-1] + (4, hidden)).sum(-1)
    sums = []
    for th in cands:
        th_cols = torch.repeat_interleave(th, hidden, dim=-1)[..., None]
        r = (a_cols + b_cols * torch.tanh(
            s_cols * (pre + grad_proj / th_cols.unsqueeze(-3)))) - target_w
        sums.append(per_gate(torch.sum(r * r, dim=(-3, -1))))
    return torch.stack(sums)


@pytest.mark.parametrize('case', ['single', 'candidates', 'tail_block',
                                  'nan_candidate', 'strided_target',
                                  'local_hidden'])
def test_torch_theta_tests_plain_matches_the_loop(case):
    """kernels/theta_tests.theta_tests (its plain version on the CPU)
    returns the loop's table bit for bit: without and with the candidate
    axis (S 3), a full block of 8 thetas and a tail block of 3, an
    instance whose slabs are NaN (its sums NaN, so every test of it
    accepts), a target that is a strided view of a longer slab, and a
    tensor-parallel rank's 2 of 5 hidden units a gate."""
    from admm_lstm_torch.core.step import gate_is_tanh
    from admm_lstm_torch.kernels.theta_tests import theta_tests
    rng = np.random.default_rng(3)
    lead = () if case == 'single' else (3,)
    seq_len, hidden, batch = 5, 2 if case == 'local_hidden' else 5, 7
    shape = lead + (seq_len, 4 * hidden, batch)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    pre = f32(rng.standard_normal(shape))
    grad_proj = f32(rng.standard_normal(shape) * 3.0)
    if case == 'strided_target':
        target_w = f32(rng.uniform(0, 1, lead + (seq_len + 2, 4 * hidden,
                                                 batch)))[..., 2:, :, :]
        assert not target_w.is_contiguous()
    else:
        target_w = f32(rng.uniform(0, 1, shape))
    if case == 'nan_candidate':
        pre[1] = float('nan')
    k = 3 if case == 'tail_block' else 8
    theta0 = f32(rng.uniform(0.5, 2.0, lead + (4,)))
    cands = theta0 * 2.0 ** torch.arange(k, dtype=torch.float32).view(
        (-1,) + (1,) * theta0.dim())
    tanh_cols = gate_is_tanh(4 * hidden, hidden, 'cpu')
    got = theta_tests(pre, grad_proj, target_w, cands, tanh_cols)
    want = _loop_sums(pre, grad_proj, target_w, cands, tanh_cols)
    assert got.shape == (k,) + lead + (4,)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    if case == 'nan_candidate':
        assert bool(got[:, 1].isnan().all())
        assert not bool((got > 0.0)[:, 1].any())    # NaN fails no test
        assert not bool(got[:, [0, 2]].isnan().any())


@pytest.mark.parametrize('cands,hidden,batch,aligned,want', [
    (27, 10, 4224, True, (4, 396)),     # the rho grid: one wave
    (1, 10, 4224, True, (4, 396)),      # the training runs: one wave
    (1, 5, 37, True, (1, 29)),          # few units: THREADS a block
    (3, 10, 4224, False, (1, 396)),     # a misaligned slab: one float
    (1, 10, 1001, True, (1, 396)),      # H * B odd: one float
    (125, 10, 4224, True, (4, 500)),    # a block for each group at least
])
def test_torch_theta_tests_plan(cands, hidden, batch, aligned, want):
    """The theta-test kernel's plan on a card of 132 SMs holding 3 blocks
    each: float4 where it can, one wave of blocks, fewer where the units
    run out, never fewer than the (instance, gate) groups."""
    from admm_lstm_torch.kernels.theta_tests import THREADS, tests_plan
    plan = tests_plan(cands, 10, hidden, batch, aligned, 132, {4: 3, 1: 3})
    assert tuple(plan) == want
    units = 4 * cands * 10 * hidden * batch // plan.vec
    assert 4 * cands <= plan.grid <= units
    assert plan.grid == max(min(396, -(-units // THREADS)), 4 * cands)
