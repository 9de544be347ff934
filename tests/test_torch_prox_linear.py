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
