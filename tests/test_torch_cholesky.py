"""The batched Cholesky kernels' plain versions
(admm_lstm_torch.kernels.cholesky) against the JAX package's Pallas kernels
run in interpret mode, the wrappers' checks, and the blocked solve
(admm_lstm_torch.solvers.blocked_chol) against the JAX package's and
against torch.cholesky_solve.  The CUDA kernels themselves are held
against the plain versions in tests/test_torch_gpu.py; the ill-conditioned
inputs and float64 references of their gate (ii) (chip_smoke.gram_inputs,
chip_smoke.reference_f64) are checked here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_lstm_tpu.kernels.cholesky import (pallas_chol_inverse,
                                            pallas_chol_solve)
from admm_lstm_tpu.solvers.blocked_chol import \
    blocked_spd_solve as j_blocked_spd_solve
from admm_lstm_torch.kernels.cholesky import (chol_inverse,
                                              chol_inverse_plain, chol_solve,
                                              chol_solve_plain)
from admm_lstm_torch.solvers.blocked_chol import blocked_spd_solve

torch.set_num_threads(1)

# f32 against the Pallas kernels: rsqrt against 1/sqrt and the order of
# the substitutions' sums; the SPD inputs M M^T + D I have condition
# numbers below 5 and solutions and inverses of magnitude below 1.
ATOL = 1e-5


def _spd(n, dim, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, dim, dim)).astype(np.float32)
    a = m @ np.transpose(m, (0, 2, 1)) + dim * np.eye(dim, dtype=np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)
    return a.astype(np.float32), b


@pytest.mark.parametrize('dim', [1, 10, 64, 100])
def test_torch_chol_solve_plain_matches_pallas(dim):
    """D <= 64 runs the JAX G-minor kernel, D = 100 the systems-major one."""
    a, b = _spd(5, dim, seed=dim)
    want = np.asarray(pallas_chol_solve(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    got = chol_solve_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, np.linalg.solve(a, b[..., None])[..., 0],
                               atol=ATOL)


@pytest.mark.parametrize('dim', [33, 64, 100])
def test_torch_chol_inverse_plain_matches_pallas(dim):
    a, _ = _spd(4, dim, seed=100 + dim)
    want = np.asarray(pallas_chol_inverse(jnp.asarray(a), interpret=True))
    got = chol_inverse_plain(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(np.triu(got, 1) == 0.0), 'nonzeros above the diagonal'
    # L^-1 a L^-T = I.
    np.testing.assert_allclose(got @ a @ np.transpose(got, (0, 2, 1)),
                               np.broadcast_to(np.eye(dim), a.shape),
                               atol=1e-4)


# Gram-like inputs of condition number 1e5: f32 solves carry forward errors
# of the order kappa * u (u = 2^-24) relative to max |x|; the plain
# versions, the Pallas kernels and float64 each sit below 5e-4 of max |x|.
ILL_KAPPA = 1e5
ILL_RTOL = ILL_KAPPA * 2.0 ** -24


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize('dim', [10, 64, 128])
def test_torch_chol_plain_matches_pallas_ill_conditioned(dim):
    """D = 10 and 64 run the JAX G-minor kernels, D = 128 its blocked
    route (block 64)."""
    a, b = chip_smoke.gram_inputs(3, dim, ILL_KAPPA, seed=dim)
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    want = np.asarray(pallas_chol_solve(ja, jb, interpret=True))
    assert _rel_err(chol_solve_plain(a, b).numpy(), want) <= ILL_RTOL
    want = np.asarray(pallas_chol_inverse(ja, interpret=True))
    got = chol_inverse_plain(a).numpy()
    assert _rel_err(got, want) <= ILL_RTOL
    assert np.all(np.triu(got, 1) == 0.0)


@pytest.mark.parametrize('dim', [1, 10, 64, 128])
def test_torch_chol_plain_matches_float64_ill_conditioned(dim):
    """The oracle of the card's gate (ii): the plain versions against
    float64 torch.linalg.cholesky / cholesky_solve / solve_triangular
    (chip_smoke.reference_f64), and that reference against numpy's
    float64 solve."""
    a, b = chip_smoke.gram_inputs(3, dim, ILL_KAPPA, seed=dim + 7)
    ref = chip_smoke.reference_f64(a, b)
    assert ref.dtype == torch.float64
    assert _rel_err(chol_solve_plain(a, b).double().numpy(),
                    ref.numpy()) <= ILL_RTOL
    a64 = a.double().numpy()
    np.testing.assert_allclose(
        ref.numpy(), np.linalg.solve(a64, b.double().numpy()[..., None])[..., 0],
        rtol=0, atol=1e-9 * float(ref.abs().max()) * ILL_KAPPA)
    refi = chip_smoke.reference_f64(a)
    assert _rel_err(chol_inverse_plain(a).double().numpy(),
                    refi.numpy()) <= ILL_RTOL
    # L^-1 a L^-T = I in float64.
    eye = refi.numpy() @ a64 @ np.transpose(refi.numpy(), (0, 2, 1))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(dim), eye.shape),
                               atol=1e-9)


@pytest.mark.parametrize('kappa', [1e5, 1e6])
@pytest.mark.parametrize('dim', [1, 10, 64, 128])
def test_torch_chol_gram_inputs_have_the_stated_condition(dim, kappa):
    """chip_smoke.gram_inputs: float32, symmetric, SPD, condition number
    kappa (1 at D = 1) within 10% after the rounding to float32."""
    a, b = chip_smoke.gram_inputs(4, dim, kappa, seed=dim)
    assert a.dtype == b.dtype == torch.float32
    assert tuple(a.shape) == (4, dim, dim) and tuple(b.shape) == (4, dim)
    assert torch.equal(a, a.transpose(1, 2))
    ev = torch.linalg.eigvalsh(a.double())
    assert bool((ev > 0).all())
    cond = (ev[:, -1] / ev[:, 0]).numpy()
    want = 1.0 if dim == 1 else kappa
    np.testing.assert_allclose(cond, want, rtol=0.1)


def test_torch_chol_wrappers_cpu_are_plain():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    a, b = map(torch.from_numpy, _spd(3, 12, seed=7))
    before = (chol_solve.launches, chol_inverse.launches)
    assert torch.equal(chol_solve(a, b), chol_solve_plain(a, b))
    assert torch.equal(chol_inverse(a), chol_inverse_plain(a))
    assert (chol_solve.launches, chol_inverse.launches) == before


@pytest.mark.parametrize('which', ['solve', 'inverse'])
def test_torch_chol_plain_reads_only_lower_triangle(which):
    """NaN above the diagonal changes nothing, bit for bit: the plain
    versions, like the kernels, read only the lower triangle of a."""
    a, b = map(torch.from_numpy, _spd(3, 17, seed=9))
    poisoned = torch.where(torch.ones(17, 17, dtype=torch.bool).triu(1),
                           torch.tensor(float('nan')), a)
    fn = ((lambda m: chol_solve_plain(m, b)) if which == 'solve'
          else chol_inverse_plain)
    assert torch.equal(fn(poisoned), fn(a))


@pytest.mark.parametrize('bad', ['dtype', 'wide', 'square', 'rhs',
                                 'contiguous'])
def test_torch_chol_wrappers_reject_bad_inputs(bad):
    a, b = map(torch.from_numpy, _spd(3, 6, seed=8))
    if bad == 'dtype':
        a = a.double()
    elif bad == 'wide':
        a, b = torch.eye(129).expand(1, 129, 129).contiguous(), torch.ones(1, 129)
    elif bad == 'square':
        a = a[:, :, :5].contiguous()
    elif bad == 'rhs':
        b = b[:, :5].contiguous()
    else:
        a = a.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        chol_solve(a, b)
    if bad != 'rhs':
        with pytest.raises((TypeError, ValueError)):
            chol_inverse(a)


@pytest.mark.parametrize('dim', [1, 128, 129, 257, 561])
def test_torch_blocked_spd_solve_matches_jax_and_cholesky_solve(dim):
    """Mirrors tests/test_solvers.py's blocked-solve cases: the identity
    pad (129, 257, 561), one block (1, 128), several strips (561)."""
    a, b = _spd(2, dim, seed=dim + 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = blocked_spd_solve(ta, tb)
    assert torch.equal(got, blocked_spd_solve(ta, tb, use_kernel=False))
    want = torch.cholesky_solve(tb[..., None], torch.linalg.cholesky(ta))
    np.testing.assert_allclose(got.numpy(), want[..., 0].numpy(), atol=ATOL)
    for diag in (False, True):
        ref = np.asarray(j_blocked_spd_solve(
            jnp.asarray(a), jnp.asarray(b), use_pallas_diag=diag))
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL,
                                   err_msg=f'use_pallas_diag={diag}')
