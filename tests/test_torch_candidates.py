"""The candidate axis of the port (admm_lstm_torch.core.state): S
independent ADMM instances in one batched epoch, against the JAX package's
`jax.vmap` of its epoch and kernel, and against the port's own epochs
alone, on the CPU.  The card's batched kernel is held to its plain
version in tests/test_torch_gpu.py.

Inputs come from numpy and go to both packages as numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu.core.init import init_admm_state as j_init
from admm_lstm_tpu.core.state import Penalties as JPenalties
from admm_lstm_tpu.core.step import admm_step as j_admm_step
from admm_lstm_tpu.core.step import rules_for as j_rules_for
from admm_lstm_tpu.core.residuals import admm_residuals_im as j_primal
from admm_lstm_tpu.core.residuals import dual_residuals as j_dual
from admm_lstm_tpu.kernels.gate_sweep import (pallas_interior_sweep,
                                              pallas_jacobi_sweep)
from admm_lstm_tpu.solvers import normal_eq as j_ne
from admm_lstm_tpu.models.lstm import LSTMParams as JParams
from admm_lstm_tpu.models.lstm import params_from_dict as j_params_from_dict
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_torch.api import batch_minor
from admm_lstm_torch.core import step as step_mod
from admm_lstm_torch.core.consensus import Consensus
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.residuals import admm_residuals_im, dual_residuals
from admm_lstm_torch.core.state import (broadcast_state,
                                        penalties_from_vectors, take)
from admm_lstm_torch.core.step import (admm_step_im, candidate_axis_refusal,
                                       rules_for)
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.kernels.gate_sweep import (interior_sweep,
                                                interior_sweep_plain,
                                                jacobi_sweep,
                                                jacobi_sweep_plain,
                                                sweep_plan)
from admm_lstm_torch.models.lstm import params_from_dict
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.solvers import normal_eq as ne
from admm_lstm_torch.solvers import prox_linear
from admm_lstm_torch.solvers.blocked_chol import blocked_spd_solve
from admm_lstm_torch.solvers.prox_linear import final_h_tests, h_final_update
from admm_lstm_torch.tune import candidate_grid
from admm_lstm_torch.utils.config import AUTO_FIELDS, RHO_KEYS, ADMMConfig

torch.set_num_threads(1)

# f32, summation order between the packages (as tests/test_torch_step.py).
STEP_ATOL = 1e-4
# f32, the H-long dot products and transcendental ulps (as
# tests/test_torch_sweep.py).
SWEEP_ATOL = 1e-5
# The batched epoch against the same epochs alone: the same f32 math, the
# sums taken per candidate.
ALONE_ATOL = 1e-5
# The exact weight stage, batched against jax.vmap of the JAX package's:
# f32 sums of (T*B)-long products in another order, then solves of
# condition ~1e2 on these inputs.
EXACT_ATOL = 1e-5
# Residuals at f32 rounding level: an RMS of differences of a few ulps
# of values below 1 (f32 eps 6e-8), with margin.
ROUNDING_LEVEL = 1e-6
S, T, H, B = 3, 5, 5, 48
SLABS = ('i', 'f', 'g', 'o', 'c', 'h')
TURBO = dict(sweep_mode='jacobi', exact_weight_solve=True,
             matmul_precision='highest')
# Every case holds to STEP_ATOL and ALONE_ATOL.  turbo() and auto() run
# at 'highest' as their parity runs do; 'turbo_default' too, because at
# these sizes 'default' rounds no product on the CPU: the exact stage's
# Gram takes the einsum strategy, which keeps f32 operands, and both CPU
# backends run f32 products in full f32 at either precision.
CASES = [
    ('fast', dict()),
    ('no_dual_y', dict(variant='no_dual_y')),
    ('with_dual_y', dict(with_dual_y=True)),
    ('wy_lipschitz', dict(wy_lipschitz=True)),
    ('adaptive_rho', dict(adaptive_rho=True)),
    ('turbo', TURBO),
    ('auto', dict(AUTO_FIELDS, matmul_precision='highest')),
    ('turbo_default', dict(TURBO, matmul_precision='default')),
]


def _np(t):
    return t.detach().float().cpu().numpy()


def _weights(seed, count=None):
    """Weights as the {'x2i', ..., 'wy'} arrays both packages take, with a
    leading candidate axis of `count` if given."""
    rng = np.random.default_rng(seed)
    lead = () if count is None else (count,)
    w = {f'x2{g}': (rng.standard_normal(lead + (2, H)) * 0.5)
         .astype(np.float32) for g in 'ifgo'}
    w.update({f'h2{g}': (rng.standard_normal(lead + (H, H)) * 0.4)
              .astype(np.float32) for g in 'ifgo'})
    w['wy'] = (rng.standard_normal(lead + (H, 1)) * 0.5).astype(np.float32)
    return w


def _data(per_candidate):
    """(x, y): (B, T, I), (B, O) shared, or (S, B, T, I), (S, B, O)."""
    if not per_candidate:
        tx, ty, _, _ = synth(batch=B, seq_len=T, input_size=2, val_batch=4,
                             seed=3)
        return tx, ty
    parts = [synth(batch=B, seq_len=T, input_size=2, val_batch=4,
                   seed=10 + s)[:2] for s in range(S)]
    return np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])


def _rho_table(rho_y=None):
    """(S, 7) rho per candidate: points of the c, h, y grid, far apart."""
    table = candidate_grid(parameter_set('Synthetic'))[[0, 13, 26]]
    if rho_y is not None:
        table[:, -1] = rho_y * np.asarray([0.5, 1.0, 2.0], np.float32)
    return table


def _states(cfgkw, per_candidate, rho_y=None):
    """The same S initial states in both packages: shared data from one
    weight set, or per-candidate data from per-candidate weights, rho
    from `_rho_table`."""
    x, y = _data(per_candidate)
    table = _rho_table(rho_y)
    ps, j_ps = parameter_set('Synthetic'), j_parameter_set('Synthetic')
    cfg, j_cfg = ADMMConfig(**cfgkw), JConfig(**cfgkw)
    if per_candidate:
        w = _weights(21, S)
        state = init_admm_state(params_from_dict(w), torch.from_numpy(x), ps,
                                cfg)
        gates = lambda side: jnp.asarray(np.stack(
            [w[f'{side}2{g}'] for g in 'ifgo'], 1))
        j_state = jax.vmap(lambda p, xs: j_init(p, xs, j_ps, j_cfg))(
            JParams(gates('x'), gates('h'), jnp.asarray(w['wy'])),
            jnp.asarray(x))
    else:
        w = _weights(21)
        state = broadcast_state(init_admm_state(
            params_from_dict(w), torch.from_numpy(x), ps, cfg), S)
        j_state = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (S,) + a.shape),
            j_init(j_params_from_dict(w), jnp.asarray(x), j_ps, j_cfg))
    state = state._replace(rho=penalties_from_vectors(table))
    j_state = j_state._replace(rho=JPenalties(
        *(jnp.asarray(table[:, k]) for k in range(7))))
    # Gates and duals i..c moved off the forward pass (row 0 stays zero;
    # the h-dual stays zero, as its rows t < T are on the main path), the
    # same numpy noise in both packages: the residuals that adaptive rho
    # compares are then well above f32 rounding.
    rng = np.random.default_rng(8)
    for group, scale in (('gates', 0.05), ('duals', 0.01)):
        noisy, j_noisy = {}, {}
        for k in SLABS[:6 if group == 'gates' else 5]:
            noise = (rng.standard_normal(getattr(state, group).i.shape)
                     * scale).astype(np.float32)
            noise[:, 0] = 0.0
            noisy[k] = getattr(getattr(state, group), k) + torch.from_numpy(
                noise)
            j_noisy[k] = getattr(getattr(j_state, group), k) + noise
        state = state._replace(**{group: getattr(state, group)._replace(
            **noisy)})
        j_state = j_state._replace(**{group: getattr(j_state, group)._replace(
            **j_noisy)})
    return cfg, j_cfg, x, y, state, j_state


def _assert_state_close(got, want, atol, label):
    for group in ('gates', 'duals'):
        for k in SLABS + (('a',) if group == 'gates' else ('y',)):
            np.testing.assert_allclose(
                _np(getattr(getattr(got, group), k)),
                np.asarray(getattr(getattr(want, group), k)), atol=atol,
                err_msg=f'{label} {group} {k}')
    for field in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(_np(getattr(got.params, field)),
                                   np.asarray(getattr(want.params, field)),
                                   atol=atol, err_msg=f'{label} {field}')
    for k in ('i', 'f', 'g', 'o', 'c', 'h', 'y'):
        np.testing.assert_allclose(_np(getattr(got.rho, k)),
                                   np.asarray(getattr(want.rho, k)),
                                   rtol=1e-6, err_msg=f'{label} rho {k}')


def _sweep_inputs(count, steps, hidden, batch, seed):
    rng = np.random.default_rng(seed)
    xproj = (rng.standard_normal((count, steps, 4, hidden, batch)) * 0.3
             ).astype(np.float32)
    wh = (rng.standard_normal((count, 4, hidden, hidden)) * 0.3
          ).astype(np.float32)
    gates = tuple((rng.standard_normal((count, steps, hidden, batch)) * 0.2)
                  .astype(np.float32) for _ in range(6))
    duals = tuple((rng.standard_normal((count, steps, hidden, batch)) * 0.01)
                  .astype(np.float32) for _ in range(6))
    rho = (np.asarray([1., 1., 1., 1., 0.01, 0.001], np.float32)
           * np.asarray([0.5, 1.0, 2.0, 4.0][:count], np.float32)[:, None])
    return xproj, wh, gates, duals, rho


@pytest.mark.parametrize('count,steps,hidden,batch', [(3, 4, 5, 16),
                                                      (4, 6, 3, 37)])
def test_torch_batched_plain_sweep_matches_vmapped_pallas(count, steps,
                                                          hidden, batch):
    """The batched plain sweep against jax.vmap of the Pallas kernel in
    interpret mode (vmap gives its pallas_call a leading grid axis)."""
    xproj, wh, gates, duals, rho = _sweep_inputs(count, steps, hidden, batch,
                                                 seed=count)
    ref_g, ref_d = jax.vmap(lambda *a: pallas_interior_sweep(
        *a, interpret=True))(jnp.asarray(xproj), jnp.asarray(wh),
                             tuple(map(jnp.asarray, gates)),
                             tuple(map(jnp.asarray, duals)), jnp.asarray(rho))
    t = torch.from_numpy
    got_g, got_d = interior_sweep_plain(t(xproj), t(wh), tuple(map(t, gates)),
                                        tuple(map(t, duals)), t(rho))
    for k, (a, b) in enumerate(zip(got_g + got_d, ref_g + ref_d)):
        assert a.shape == (count, steps, hidden, batch)
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=SWEEP_ATOL,
                                   err_msg=f'output {k}')


def test_torch_batched_sweep_wrapper_takes_strided_slabs():
    """On CPU tensors the wrapper runs the plain version for the axis too,
    and takes slabs that are slices of (S, T+1, H, B) state slabs (one
    candidate stride, contiguous within a candidate) and an xproj that is
    a slice of the epoch's projection; it refuses slabs that are not."""
    xproj, wh, gates, duals, rho = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else
        tuple(map(torch.from_numpy, a))
        for a in _sweep_inputs(3, 4, 5, 8, seed=7))
    padded = [torch.cat([torch.zeros_like(s[:, :1]), s,
                         torch.zeros_like(s[:, :1])], dim=1)
              for s in gates + duals]
    sliced = [s[:, 1:-1] for s in padded]
    xfull = torch.cat([xproj, torch.zeros_like(xproj[:, :1])], dim=1)
    before = interior_sweep.launches
    got = interior_sweep(xfull[:, :-1], wh, sliced[:6], sliced[6:], rho)
    want = interior_sweep_plain(xproj, wh, gates, duals, rho)
    assert interior_sweep.launches == before
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='within a candidate'):
        interior_sweep(xproj, wh, [s.transpose(-2, -1).contiguous()
                                   .transpose(-2, -1) for s in gates],
                       duals, rho)
    with pytest.raises(ValueError, match='rho_vec'):
        interior_sweep(xproj, wh, gates, duals, rho[0])


@pytest.mark.parametrize('count,hidden,batch', [(1, 10, 4224), (27, 10, 4224),
                                                (4, 10, 340), (5, 130, 512)])
def test_torch_sweep_plan_for_candidates(count, hidden, batch):
    """The plan for S * B columns: one candidate is the plan without the
    axis; the grid is S times the batch's tiles, at least the SMs' worth
    where the columns allow."""
    plain = sweep_plan(hidden, batch, 132, 232448)
    plan = sweep_plan(hidden, batch, 132, 232448, candidates=count)
    if count == 1:
        assert plan == plain
    assert plan.grid == count * -(-batch // plan.tb)
    assert plan.grid >= min(132, count * -(-batch // 8))
    with pytest.raises(ValueError, match='candidates'):
        sweep_plan(hidden, batch, 132, 232448, candidates=0)


@pytest.mark.parametrize('per_candidate', [False, True],
                         ids=['shared_data', 'per_candidate_data'])
@pytest.mark.parametrize('name,cfgkw', CASES)
def test_torch_batched_step_matches_jax_vmap(name, cfgkw, per_candidate):
    """One batched epoch against jax.vmap of the JAX package's admm_step,
    from the same S states with a different rho per candidate (rho_y 2, 4
    and 8 under wy_lipschitz, so that the safeguard binds for each)."""
    rho_y = 4.0 if cfgkw.get('wy_lipschitz') else None
    cfg, j_cfg, x, y, state, j_state = _states(cfgkw, per_candidate, rho_y)
    j_rules = j_rules_for(j_cfg)
    in_axes = (0, 0, 0) if per_candidate else (0, None, None)
    j_new = jax.jit(jax.vmap(lambda s, a, b: j_admm_step(s, a, b, j_rules),
                             in_axes=in_axes))(j_state, jnp.asarray(x),
                                               jnp.asarray(y))
    x_im, y_im, _, _ = batch_minor(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(x), torch.from_numpy(y))
    if cfg.wy_lipschitz:
        h_last = state.gates.h[:, -1]
        lip = state.rho.y * torch.linalg.eigvalsh(h_last @ h_last.mT)[:, -1]
        assert bool((lip > rules_for(cfg).wy_theta).all()), lip
    new = admm_step_im(state, x_im, y_im, rules_for(cfg))
    assert new.candidates == S and new.epoch == 1
    _assert_state_close(new, j_new, STEP_ATOL, name)


def _spy_thetas(monkeypatch):
    """Records the theta of every weight stage and final-h search."""
    log = []
    for name in ('weight_stage_update_wide', 'h_final_update'):
        fn = getattr(step_mod, name)

        def spy(*a, _fn=fn, **k):
            res = _fn(*a, **k)
            log.append(res.theta)
            return res
        monkeypatch.setattr(step_mod, name, spy)
    return log


@pytest.mark.parametrize('per_candidate', [False, True],
                         ids=['shared_data', 'per_candidate_data'])
@pytest.mark.parametrize('name,cfgkw', CASES)
def test_torch_batched_epochs_match_epochs_alone(monkeypatch, name, cfgkw,
                                                 per_candidate):
    """Three batched epochs against each candidate's three epochs alone:
    every line search's theta equal, every leaf within ALONE_ATOL."""
    cfg, _, x, y, state, _ = _states(cfgkw, per_candidate)
    rules = rules_for(cfg)
    thetas = _spy_thetas(monkeypatch)
    x_t, y_t = torch.from_numpy(x), torch.from_numpy(y)
    x_im, y_im, _, _ = batch_minor(x_t, y_t, x_t, y_t)
    batched = state
    for _ in range(3):
        batched = admm_step_im(batched, x_im, y_im, rules)
    batched_thetas = list(thetas)
    for s in range(S):
        thetas.clear()
        alone = take(state, s)
        xs, ys = (x_im[s], y_im[s]) if per_candidate else (x_im, y_im)
        for _ in range(3):
            alone = admm_step_im(alone, xs, ys, rules)
        # The final-h search each epoch, and the two prox-linear weight
        # stages where no exact stage takes their place.
        searches = 3 * (1 if cfg.exact_weight_solve else 3)
        assert len(thetas) == len(batched_thetas) == searches
        for k, (a, b) in enumerate(zip(batched_thetas, thetas)):
            assert torch.equal(a[s].reshape(b.shape), b), (name, s, k)
        got = take(batched, s)
        for leaf_got, leaf_alone in zip(
                [*got.params, *got.gates, *got.duals, *got.rho],
                [*alone.params, *alone.gates, *alone.duals, *alone.rho]):
            np.testing.assert_allclose(_np(leaf_got), _np(leaf_alone),
                                       atol=ALONE_ATOL, err_msg=name)


@pytest.mark.parametrize('theta0,theta_max,max_iters,iters_bind', [
    (0.1, 1.0, 60, False),          # theta0 < theta_max
    (2.0, 1.0, 60, False),          # theta0 >= theta_max: one test
    (1e-7, 1e9, 3, True),           # max_iters binds before theta_max
])
@pytest.mark.parametrize('flavor', ['fast', 'no_dual_y'])
def test_torch_batched_final_h_cap_cases(theta0, theta_max, max_iters,
                                         iters_bind, flavor):
    """The batched final-h search gives each candidate the theta of its
    search alone, the untested cap included: the host's count of tests,
    min(max_iters, the doublings that reach theta_max), in f32."""
    rng = np.random.default_rng(5)
    count, hidden, batch = 4, 5, 24
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32))
    h_old, o_new, tanh_c = (f(count, hidden, batch, scale=0.5)
                            for _ in range(3))
    lam_h = f(count, hidden, batch, scale=0.01)
    wy, a_old = f(count, hidden, 1, scale=0.5), f(count, 1, batch)
    lam_y = f(count, 1, batch, scale=0.01)
    rho_h = torch.tensor([1e-3, 1e-2, 0.1, 1.0])
    rho_y = torch.tensor([1e-3, 0.5, 2.0, 8.0])
    kw = dict(with_dual_y=False, theta0=theta0, theta_max=theta_max,
              max_iters=max_iters, grad_uses_rho_h=flavor == 'no_dual_y',
              probe_is_grad_over_theta=flavor == 'no_dual_y')
    view = lambda r: r[:, None, None]
    batched = h_final_update(
        h_old, o_new, tanh_c, lam_h, view(rho_h), wy, a_old, view(rho_y),
        lam_y, to_out=lambda v: torch.einsum('...hb,...ho->...ob', v, wy),
        from_out=lambda r: torch.einsum('...ob,...ho->...hb', r, wy), **kw)
    n = final_h_tests(theta0, theta_max, max_iters)
    cap = np.float32(theta0) * np.float32(2.0 ** n) / 2
    capped = 0
    for s in range(count):
        alone = h_final_update(
            h_old[s], o_new[s], tanh_c[s], lam_h[s], rho_h[s], wy[s],
            a_old[s], rho_y[s], lam_y[s],
            to_out=lambda v, w=wy[s]: torch.einsum('hb,ho->ob', v, w),
            from_out=lambda r, w=wy[s]: torch.einsum('ob,ho->hb', r, w), **kw)
        assert float(batched.theta[s]) == float(alone.theta), s
        np.testing.assert_allclose(_np(batched.h[s]), _np(alone.h),
                                   atol=ALONE_ATOL)
        capped += float(alone.theta) == float(cap)
    assert n == {60: 4 if theta0 < theta_max else 1}.get(max_iters, 3)
    if iters_bind:                  # some candidate ends at the cap
        assert capped > 0


def test_torch_final_h_tests_counts_as_the_loop_doubles():
    assert final_h_tests(0.1, 1.0, 60) == 4      # 0.1 .. 0.8, 1.6 stops
    assert final_h_tests(0.25, 1.0, 60) == 2     # 0.25, 0.5; 1.0 stops
    assert final_h_tests(1.0, 1.0, 60) == 1
    assert final_h_tests(0.1, 1.0, 2) == 2
    assert final_h_tests(0.1, 1.0, 0) == 0


def test_torch_nan_candidate_leaves_the_others():
    """A candidate that diverges (rho_y NaN) accepts at once in every line
    search and never holds the others: they end equal to a batch without
    it, and its losses are not finite."""
    cfg, _, x, y, state, _ = _states(dict(wy_lipschitz=True), False)
    rules = rules_for(cfg)
    x_im, y_im, _, _ = batch_minor(*(torch.from_numpy(a)
                                     for a in (x, y, x, y)))
    rho = state.rho._replace(y=state.rho.y.clone())
    rho.y[1] = float('nan')
    with_nan = state._replace(rho=rho)
    without = take(state, slice(0, 3, 2))
    for _ in range(2):
        with_nan = admm_step_im(with_nan, x_im, y_im, rules)
        without = admm_step_im(without, x_im, y_im, rules)
    assert not bool(torch.isfinite(with_nan.gates.a[1]).all())
    kept = take(with_nan, slice(0, 3, 2))
    for a, b in zip([*kept.params, *kept.gates, *kept.duals],
                    [*without.params, *without.gates, *without.duals]):
        assert torch.equal(a, b)


def test_torch_batched_epoch_host_reads(monkeypatch):
    """A batched epoch makes one host read per block of every line search
    for all S candidates: each weight stage as many blocks as its
    most-searching candidate alone, and one block for the final-h search
    (its tests fit one block).  So it reads no more often than the
    most-searching candidate's epoch alone, and not S times as often."""
    cfg, _, x, y, state, _ = _states({}, False)
    rules = rules_for(cfg)
    x_im, y_im, _, _ = batch_minor(*(torch.from_numpy(a)
                                     for a in (x, y, x, y)))
    reads, blocks = [], []
    real_bool = torch.Tensor.__bool__
    real_search = prox_linear.doubling_search

    def counting_bool(t):
        reads.append(1)
        return real_bool(t)

    def counting_search(*a, **k):
        theta, k_done = real_search(*a, **k)
        blocks.append(k_done // prox_linear.BLOCK_K)
        return theta, k_done

    monkeypatch.setattr(torch.Tensor, '__bool__', counting_bool)
    monkeypatch.setattr(prox_linear, 'doubling_search', counting_search)

    def epoch_reads(st, xs, ys):
        reads.clear()
        blocks.clear()
        admm_step_im(st, xs, ys, rules)
        return len(reads), list(blocks)

    batched_reads, batched_blocks = epoch_reads(state, x_im, y_im)
    alone = [epoch_reads(take(state, s), x_im, y_im) for s in range(S)]
    stage_blocks = [max(a[1][k] for a in alone) for k in range(2)]
    assert batched_blocks == stage_blocks + [1]
    assert batched_reads == sum(batched_blocks)
    assert batched_reads <= max(a[0] for a in alone)
    assert final_h_tests(rules.h_theta0, rules.h_theta_max,
                         rules.max_backtrack) <= prox_linear.BLOCK_K


@pytest.mark.parametrize('layout', ['shard_time', 'model_axis'])
def test_torch_candidate_axis_refuses_what_it_does_not_take(layout):
    """The epoch with the candidate axis raises under the sharded layouts
    (the JAX package vmaps no sharded run), and takes turbo() and auto()
    in one process."""
    cfg, _, x, y, state, _ = _states({}, False)
    x_im, y_im, _, _ = batch_minor(*(torch.from_numpy(a)
                                     for a in (x, y, x, y)))
    for config in (ADMMConfig.turbo(), ADMMConfig.auto()):
        assert candidate_axis_refusal(rules_for(config)) is None
    rules = rules_for(ADMMConfig.turbo())
    rules = (dataclasses.replace(rules, shard_time=True)
             if layout == 'shard_time' else
             dataclasses.replace(rules, model=Consensus(world=2)))
    assert 'one process' in candidate_axis_refusal(rules)
    with pytest.raises(ValueError, match='one process'):
        admm_step_im(state, x_im, y_im, rules)


def test_torch_batched_init_with_shared_data_matches_inits_alone():
    """Per-candidate weights on data shared by the candidates: each
    candidate's initial state is its init alone; per-candidate data with
    shared weights is refused."""
    x, _ = _data(False)
    w = _weights(31, S)
    ps = parameter_set('Synthetic')
    state = init_admm_state(params_from_dict(w), torch.from_numpy(x), ps)
    assert state.candidates == S and state.rho.y.shape == (S,)
    for s in range(S):
        alone = init_admm_state(params_from_dict({k: v[s] for k, v in
                                                  w.items()}),
                                torch.from_numpy(x), ps)
        got = take(state, s)
        for a, b in zip([*got.params, *got.gates, *got.duals, *got.rho,
                         *got.beta],
                        [*alone.params, *alone.gates, *alone.duals,
                         *alone.rho, *alone.beta]):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)
    xs, _ = _data(True)
    with pytest.raises(ValueError, match='per-candidate weights'):
        init_admm_state(params_from_dict(_weights(31)), torch.from_numpy(xs),
                        ps)


def test_torch_configs_without_the_axis_train_one_after_another():
    """Under turbo() (the exact weight solve and the Jacobi sweep) search_rho
    and train_scenarios train their candidates as one batched program:
    each one's losses are its run alone, within 1e-6 relative (f32; the
    batched products may sum in another order than a run alone)."""
    from admm_lstm_torch import api, tune
    tx, ty, vx, vy = synth(batch=B, seq_len=T, input_size=2, val_batch=8,
                           seed=3)
    ps = parameter_set('Synthetic')
    cfg = ADMMConfig.turbo(hidden_size=H, epochs=2)
    w = _weights(21)
    table = _rho_table()
    got = tune.search_rho(tx, ty, vx, vy, ps, cfg, candidates=table,
                          epochs=2, params=params_from_dict(w), device='cpu')
    for s, cand in enumerate(table):
        pset = type(ps)(rho=dict(zip(RHO_KEYS, map(float, cand))),
                        beta=ps.beta)
        alone = api.train(tx, ty, vx, vy, pset, cfg,
                          params=params_from_dict(w), log_every=0,
                          device='cpu')
        np.testing.assert_allclose(got['val_losses'][s], alone['val_loss'][-1],
                                   rtol=1e-6)
    scen = [synth(batch=B, seq_len=T, input_size=2, val_batch=8,
                  seed=10 + s) for s in range(2)]
    data = tuple(np.stack([sc[k] for sc in scen]) for k in range(4))
    ws = _weights(41, 2)
    res = api.train_scenarios(*data, ps, cfg, params=params_from_dict(ws),
                              device='cpu')
    for s in range(2):
        alone = api.train(*(d[s] for d in data), ps, cfg,
                          params=params_from_dict({k: v[s] for k, v in
                                                   ws.items()}),
                          log_every=0, device='cpu')
        np.testing.assert_allclose(res['val_loss'][s], alone['val_loss'],
                                   rtol=1e-6)


def _jacobi_inputs(count, steps, hidden, batch, seed):
    """`_sweep_inputs` with pre in place of xproj and the previous sweep's
    h and c."""
    pre, _, gates, duals, rho = _sweep_inputs(count, steps, hidden, batch,
                                              seed)
    rng = np.random.default_rng(seed + 100)
    h_prev, c_prev = ((rng.standard_normal((count, steps, hidden, batch))
                       * 0.2).astype(np.float32) for _ in range(2))
    return pre, gates, duals, h_prev, c_prev, rho


@pytest.mark.parametrize('count,steps,hidden,batch', [(3, 4, 5, 16),
                                                      (2, 6, 3, 37)])
def test_torch_batched_plain_jacobi_sweep_matches_vmapped_pallas(
        count, steps, hidden, batch):
    """The batched plain Jacobi sweep against jax.vmap of the Pallas
    kernel in interpret mode, and each candidate against the sweep
    alone."""
    pre, gates, duals, h_prev, c_prev, rho = _jacobi_inputs(
        count, steps, hidden, batch, seed=count)
    j = jnp.asarray
    ref_g, ref_d = jax.vmap(lambda *a: pallas_jacobi_sweep(
        *a, interpret=True))(j(pre), tuple(map(j, gates)),
                             tuple(map(j, duals)), j(h_prev), j(c_prev),
                             j(rho))
    t = torch.from_numpy
    args = (t(pre), tuple(map(t, gates)), tuple(map(t, duals)), t(h_prev),
            t(c_prev), t(rho))
    got_g, got_d = jacobi_sweep_plain(*args)
    for k, (a, b) in enumerate(zip(got_g + got_d, ref_g + ref_d)):
        assert a.shape == (count, steps, hidden, batch)
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=SWEEP_ATOL,
                                   err_msg=f'output {k}')
    for c in range(count):
        alone = jacobi_sweep_plain(args[0][c], [g[c] for g in args[1]],
                                   [d[c] for d in args[2]], args[3][c],
                                   args[4][c], args[5][c])
        for a, b in zip(got_g + got_d, alone[0] + alone[1]):
            assert torch.equal(a[c], b)


def test_torch_batched_jacobi_wrapper_takes_strided_slabs():
    """On CPU tensors `jacobi_sweep` runs the plain version for the axis
    too, and takes slabs that are slices of (S, T+1, H, B) state slabs
    (one candidate stride, contiguous within a candidate), h_prev and
    c_prev among them; it refuses slabs that are not, and a rho without
    the axis."""
    pre, gates, duals, h_prev, c_prev, rho = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else
        tuple(map(torch.from_numpy, a))
        for a in _jacobi_inputs(3, 4, 5, 8, seed=7))
    padded = [torch.cat([torch.zeros_like(s[:, :1]), s,
                         torch.zeros_like(s[:, :1])], dim=1)
              for s in (*gates, *duals, h_prev, c_prev)]
    sliced = [s[:, 1:-1] for s in padded]
    before = jacobi_sweep.launches
    got = jacobi_sweep(pre, sliced[:6], sliced[6:12], sliced[12], sliced[13],
                       rho)
    want = jacobi_sweep_plain(pre, gates, duals, h_prev, c_prev, rho)
    assert jacobi_sweep.launches == before
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='within a candidate'):
        jacobi_sweep(pre, gates, duals, h_prev,
                     c_prev.transpose(-2, -1).contiguous().transpose(-2, -1),
                     rho)
    with pytest.raises(ValueError, match='one candidate stride'):
        jacobi_sweep(pre, sliced[:6], duals, h_prev, c_prev, rho)
    with pytest.raises(ValueError, match='rho_vec'):
        jacobi_sweep(pre, gates, duals, h_prev, c_prev, rho[0])


def _stage_inputs(count, dim, per_candidate):
    """`count` candidates' exact-stage inputs in the wide layout (as
    tests/test_torch_normal_eq.py's): m shared (T, D, B) or per candidate,
    the rest per candidate, rho and beta differing."""
    steps, hidden, batch = 4, 3, 24
    rng = np.random.default_rng(dim + 7 * per_candidate)
    m_shape = ((count,) if per_candidate else ()) + (steps, dim, batch)
    m = (rng.standard_normal(m_shape) / np.sqrt(dim)).astype(np.float32)
    w = (rng.standard_normal((count, dim, 4 * hidden)) * 0.5).astype(
        np.float32)
    other = (rng.standard_normal((count, steps, 4 * hidden, batch)) * 0.3
             ).astype(np.float32)
    pre = (np.einsum('...tdb,...dk->...tkb', m, w) + other).astype(np.float32)
    target = rng.uniform(-0.5, 0.9, (count, steps, 4 * hidden, batch)
                         ).astype(np.float32)
    scale = np.asarray([0.5, 1.0, 2.0][:count], np.float32)[:, None]
    rho = np.asarray([1.0, 0.8, 1.2, 0.5], np.float32) * scale
    beta = np.asarray([0.1, 0.2, 0.05, 0.3], np.float32) * scale
    tanh_cols = np.repeat(np.asarray([False, False, True, False]), hidden)
    return m, pre, w, target, rho, beta, tanh_cols


@pytest.mark.parametrize('per_candidate', [False, True],
                         ids=['shared_m', 'per_candidate_m'])
@pytest.mark.parametrize('dim,strategy', [(3, None), (10, 'wide'),
                                          (130, 'blocktri')])
def test_torch_batched_exact_stage_matches_jax_vmap(monkeypatch, dim,
                                                    strategy, per_candidate):
    """The exact weight stage of S candidates in one call against
    jax.vmap of the JAX package's, and against each candidate's stage
    alone: the Gram per candidate (einsum, or forced wide or blocktri),
    one batched solve of the S x 4H systems (chol_solve's plain version,
    or the blocked solve at D = 130), at 'highest'."""
    if strategy:
        monkeypatch.setenv('ADMM_GRAM_STRATEGY', strategy)
        monkeypatch.setattr(ne, '_gram_strategy', lambda *a: strategy)
    args = _stage_inputs(S, dim, per_candidate)
    in_axes = (0 if per_candidate else None, 0, 0, 0, 0, 0, None)
    want = jax.vmap(lambda *a: j_ne.gauss_newton_ridge_update_wide(
        *a, jax.lax.Precision.HIGHEST), in_axes=in_axes)(
            *map(jnp.asarray, args))
    t_args = tuple(map(torch.from_numpy, args))
    solves = []
    real = ne.chol_solve_plain if dim <= 128 else ne.blocked_spd_solve
    name = 'chol_solve' if dim <= 128 else 'blocked_spd_solve'
    monkeypatch.setattr(ne, name, lambda *a, **k: solves.append(a[0].shape)
                        or real(*a, **k))
    got = ne.gauss_newton_ridge_update_wide(*t_args, 'highest')
    assert got.shape == (S, dim, 12)
    assert solves == [(S * 12, dim, dim)]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=EXACT_ATOL,
                               atol=EXACT_ATOL)
    for c in range(S):
        alone = ne.gauss_newton_ridge_update_wide(
            t_args[0][c] if per_candidate else t_args[0],
            *(a[c] for a in t_args[1:6]), t_args[6], 'highest')
        np.testing.assert_allclose(_np(got[c]), _np(alone), rtol=ALONE_ATOL,
                                   atol=ALONE_ATOL)


def test_torch_blocked_spd_solve_on_candidates():
    """blocked_spd_solve on S x K systems at D = 130 (4H = 8 columns of 3
    candidates in one batch, the diagonal blocks of all of them through
    one chol_inverse call a panel) against each candidate's K systems
    alone and against torch.linalg.solve."""
    rng = np.random.default_rng(4)
    count, cols, dim = 3, 8, 130
    m = rng.standard_normal((count * cols, dim, dim)).astype(np.float32)
    a = torch.from_numpy(m @ m.transpose(0, 2, 1) / dim
                         + np.eye(dim, dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((count * cols, dim)).astype(
        np.float32))
    got = blocked_spd_solve(a, b)
    for c in range(count):
        rows = slice(c * cols, (c + 1) * cols)
        np.testing.assert_allclose(_np(got[rows]),
                                   _np(blocked_spd_solve(a[rows], b[rows])),
                                   rtol=ALONE_ATOL, atol=ALONE_ATOL)
    np.testing.assert_allclose(_np(got), _np(torch.linalg.solve(a, b)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('per_candidate', [False, True],
                         ids=['shared_data', 'per_candidate_data'])
def test_torch_adaptive_rho_tie_at_the_forward_pass_init(per_candidate):
    """The adaptive-rho choice from the forward-pass init (no noise), the
    `_rho_table` grid: wherever the two packages' new rho differ for a
    candidate and family, it is a tie: both packages' primal and dual
    residuals of that family are below ROUNDING_LEVEL, so `r > mu * s`
    compares f32 rounding (core/residuals.balanced_rho in both
    packages)."""
    cfgkw = dict(adaptive_rho=True)
    x, y = _data(per_candidate)
    table = _rho_table()
    ps, j_ps = parameter_set('Synthetic'), j_parameter_set('Synthetic')
    cfg, j_cfg = ADMMConfig(**cfgkw), JConfig(**cfgkw)
    w = _weights(21, S if per_candidate else None)
    if per_candidate:
        state = init_admm_state(params_from_dict(w), torch.from_numpy(x), ps,
                                cfg)
        gates = lambda side: jnp.asarray(np.stack(
            [w[f'{side}2{g}'] for g in 'ifgo'], 1))
        j_state = jax.vmap(lambda p, xs: j_init(p, xs, j_ps, j_cfg))(
            JParams(gates('x'), gates('h'), jnp.asarray(w['wy'])),
            jnp.asarray(x))
    else:
        state = broadcast_state(init_admm_state(
            params_from_dict(w), torch.from_numpy(x), ps, cfg), S)
        j_state = jax.tree.map(
            lambda a: jnp.broadcast_to(a[None], (S,) + a.shape),
            j_init(j_params_from_dict(w), jnp.asarray(x), j_ps, j_cfg))
    state = state._replace(rho=penalties_from_vectors(table))
    j_state = j_state._replace(rho=JPenalties(
        *(jnp.asarray(table[:, k]) for k in range(7))))
    j_rules = j_rules_for(j_cfg)
    axes = 0 if per_candidate else None
    j_x_im = jnp.asarray(np.moveaxis(x, -3, -1))      # (..., T, I, B)
    j_new = jax.jit(jax.vmap(lambda s, a, b: j_admm_step(s, a, b, j_rules),
                             in_axes=(0, axes, axes)))(
        j_state, jnp.asarray(x), jnp.asarray(y))
    j_kept = j_new._replace(rho=j_state.rho)
    j_r = jax.vmap(lambda s, xi: j_primal(s, xi, jax.lax.Precision.HIGHEST),
                   in_axes=(0, axes))(j_kept, j_x_im)
    j_s = jax.vmap(j_dual)(j_kept, j_state.gates)

    x_im, y_im, _, _ = batch_minor(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(x), torch.from_numpy(y))
    new = admm_step_im(state, x_im, y_im, rules_for(cfg))
    kept = new._replace(rho=state.rho)
    r, s_ = admm_residuals_im(kept, x_im), dual_residuals(kept, state.gates)
    ties = []
    for k in RHO_KEYS:
        got = _np(getattr(new.rho, k))
        want = np.asarray(getattr(j_new.rho, k))
        for c in np.nonzero(got != want)[0]:
            vals = [float(r[f'r_{k}'][c]), float(s_[f's_{k}'][c]),
                    float(j_r[f'r_{k}'][c]), float(j_s[f's_{k}'][c])]
            ties.append((k, int(c), got[c], want[c], vals))
            assert max(vals) < ROUNDING_LEVEL, (
                f'rho_{k} of candidate {c}: {got[c]} against JAX\'s '
                f'{want[c]}, residuals (port r, s, JAX r, s) {vals}')
    print(f'adaptive-rho ties at the forward-pass init: {ties}')
