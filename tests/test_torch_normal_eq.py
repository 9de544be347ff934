"""The exact weight solve (admm_lstm_torch.solvers.normal_eq) against the
JAX package's, on the CPU: each Gram strategy forced, at 'highest' and at
'default' (where the JAX package rounds the wide Gram operands to bf16),
and both Gauss-Newton ridge updates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from admm_lstm_tpu.solvers import normal_eq as j_ne
from admm_lstm_torch.solvers import normal_eq as ne

torch.set_num_threads(1)

PRECISIONS = {'highest': lax.Precision.HIGHEST,
              'default': lax.Precision.DEFAULT}
# f32 sums of (T*B)-long products taken in another order; relative to the
# Gram's scale.
RTOL, ATOL = 1e-5, 1e-5


def _slabs(steps, n_cols, dim, batch, seed):
    rng = np.random.default_rng(seed)
    s2 = rng.uniform(0.0, 0.25, (steps, n_cols, batch)).astype(np.float32)
    wres = (rng.standard_normal((steps, n_cols, batch)) * 0.1).astype(np.float32)
    m = rng.standard_normal((steps, dim, batch)).astype(np.float32)
    return s2, wres, m


@pytest.mark.parametrize('precision', ['highest', 'default'])
@pytest.mark.parametrize('strategy', ne.GRAM_STRATEGIES)
@pytest.mark.parametrize('dim', [5, 130])
def test_torch_gram_bvec_matches_jax(monkeypatch, strategy, precision, dim):
    """D = 130 gives blocktri two row blocks, one of them ragged."""
    s2, wres, m = _slabs(3, 8, dim, 20, seed=dim)
    monkeypatch.setenv('ADMM_GRAM_STRATEGY', strategy)
    j_gram, j_bvec = j_ne._gram_bvec(jnp.asarray(s2), jnp.asarray(wres),
                                     jnp.asarray(m), PRECISIONS[precision])
    gram, bvec = ne._gram_bvec(torch.from_numpy(s2), torch.from_numpy(wres),
                               torch.from_numpy(m), precision,
                               strategy=strategy)
    assert gram.shape == (8, dim, dim) and bvec.shape == (8, dim)
    np.testing.assert_allclose(gram.numpy(), np.asarray(j_gram), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(bvec.numpy(), np.asarray(j_bvec), rtol=RTOL,
                               atol=ATOL)


def test_torch_gram_default_rounds_wide_operands_to_bf16():
    """At 'default' the wide Gram differs from the f32 one by bf16
    rounding (the mirror is live), and the einsum Gram does not."""
    s2, wres, m = map(torch.from_numpy, _slabs(3, 4, 6, 16, seed=1))
    f32, _ = ne._gram_bvec(s2, wres, m, 'highest', strategy='wide')
    bf, _ = ne._gram_bvec(s2, wres, m, 'default', strategy='wide')
    ein, _ = ne._gram_bvec(s2, wres, m, 'default', strategy='einsum')
    assert float((f32 - bf).abs().max()) > 1e-4
    np.testing.assert_allclose(ein.numpy(), f32.numpy(), rtol=RTOL, atol=ATOL)


def _wide_inputs(steps, dim, hidden, batch, seed):
    rng = np.random.default_rng(seed)
    m = (rng.standard_normal((steps, dim, batch)) / np.sqrt(dim)).astype(np.float32)
    w = (rng.standard_normal((dim, 4 * hidden)) * 0.5).astype(np.float32)
    other = (rng.standard_normal((steps, 4 * hidden, batch)) * 0.3).astype(np.float32)
    pre = np.einsum('tdb,dk->tkb', m, w) + other
    target = rng.uniform(-0.5, 0.9, (steps, 4 * hidden, batch)).astype(np.float32)
    rho = np.asarray([1.0, 0.8, 1.2, 0.5], np.float32)
    beta = np.asarray([0.1, 0.2, 0.05, 0.3], np.float32)
    tanh_cols = np.repeat(np.asarray([False, False, True, False]), hidden)
    return m, pre.astype(np.float32), w, target, rho, beta, tanh_cols


@pytest.mark.parametrize('precision', ['highest', 'default'])
@pytest.mark.parametrize('dim,strategy', [(3, None), (10, 'wide'),
                                          (130, None), (130, 'blocktri')])
def test_torch_gauss_newton_wide_matches_jax(monkeypatch, dim, strategy,
                                             precision):
    """D = 3 and 10 take chol_solve, D = 130 the blocked solve; the Gram
    runs as the einsum unless forced.

    Tolerance: the weights solve systems of condition ~1e2-1e3, so 1e-4.
    A forced wide or blocktri Gram at 'default' rounds s2 = act'^2 to bf16
    in both packages, and an ulp of difference between their tanh flips
    some of those roundings (2^-9 relative each); the solve amplifies that
    to ~3e-3, hence 5e-3 there.  test_torch_gram_bvec_matches_jax holds
    the bf16 Grams themselves at 1e-5 on equal inputs."""
    args = _wide_inputs(4, dim, 3, 24, seed=dim)
    if strategy:
        monkeypatch.setenv('ADMM_GRAM_STRATEGY', strategy)
        monkeypatch.setattr(ne, '_gram_strategy', lambda *a: strategy)
    want = j_ne.gauss_newton_ridge_update_wide(
        *map(jnp.asarray, args), PRECISIONS[precision])
    got = ne.gauss_newton_ridge_update_wide(
        *map(torch.from_numpy, args), precision)
    assert got.shape == (dim, 12)
    tol = 5e-3 if strategy and precision == 'default' else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize('dim', [2, 130])
def test_torch_gauss_newton_stacked_matches_jax(dim):
    rng = np.random.default_rng(dim)
    steps, batch, hidden = 3, 16, 4
    m = (rng.standard_normal((steps, batch, dim)) / np.sqrt(dim)).astype(np.float32)
    fixed = (rng.standard_normal((4, steps, batch, hidden)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((4, dim, hidden)) * 0.5).astype(np.float32)
    target = rng.uniform(-0.5, 0.9, (4, steps, batch, hidden)).astype(np.float32)
    rho = np.asarray([1.0, 0.8, 1.2, 0.5], np.float32)
    beta = np.asarray([0.1, 0.2, 0.05, 0.3], np.float32)
    is_tanh = np.asarray([False, False, True, False])
    args = (m, fixed, w, target, rho, beta, is_tanh)
    want = j_ne.gauss_newton_ridge_update(*map(jnp.asarray, args),
                                          lax.Precision.HIGHEST)
    got = ne.gauss_newton_ridge_update(*map(torch.from_numpy, args))
    assert got.shape == (4, dim, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
