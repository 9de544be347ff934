"""The port's epoch (admm_lstm_torch.core.step) against the reference's
3-step goldens and against the JAX package's `make_admm_step`, on the CPU.

Inputs come from numpy (goldens, the Synthetic loader) and the same
weights go to both packages as numpy arrays.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu.core.init import init_admm_state as j_init
from admm_lstm_tpu.core.step import make_admm_step as j_make_step
from admm_lstm_tpu.models.lstm import params_from_dict as j_params_from_dict
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.core.state import to_batch_major
from admm_lstm_torch.core.step import make_admm_step, rules_for
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.models.lstm import params_from_dict, params_from_numpy
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import AUTO_FIELDS, ADMMConfig

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
STATE_ATOL = 2e-4   # f32, reference torch eager vs the port, 3 steps
GOLDEN_VARIANTS = [
    ('fast', dict(variant='fast')),
    ('fast_wide', dict(variant='fast')),   # H=64, I=9 instance
    ('fast_dual_y', dict(variant='fast', with_dual_y=True)),
    ('no_dual_y', dict(variant='no_dual_y')),
]
SLABS = ('i', 'f', 'g', 'o', 'c', 'h')


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.mark.parametrize('variant,cfgkw', GOLDEN_VARIANTS)
def test_torch_three_step_golden_parity(variant, cfgkw):
    g = np.load(os.path.join(GOLDEN, f'small_{variant}_3steps.npz'))
    x, y = torch.from_numpy(g['x']), torch.from_numpy(g['y'])
    params = params_from_dict({k[3:]: g[k] for k in g.files
                               if k.startswith('w0_')})
    cfg = ADMMConfig(**cfgkw)
    state = init_admm_state(params, x, parameter_set('Synthetic'), cfg)
    for k in SLABS:
        np.testing.assert_allclose(_np(to_batch_major(getattr(state.gates, k))),
                                   g[f's0_gate_{k}'], atol=1e-4,
                                   err_msg=f'init gate {k}')
    step = make_admm_step(cfg)
    for s in (1, 2, 3):
        state = step(state, x, y)
        for k in SLABS:
            np.testing.assert_allclose(
                _np(to_batch_major(getattr(state.gates, k))),
                g[f's{s}_gate_{k}'], atol=STATE_ATOL,
                err_msg=f'{variant} step {s} gate {k}')
            np.testing.assert_allclose(
                _np(to_batch_major(getattr(state.duals, k))),
                g[f's{s}_dual_{k}'], atol=STATE_ATOL,
                err_msg=f'{variant} step {s} dual {k}')
        np.testing.assert_allclose(_np(state.gates.a).T, g[f's{s}_gate_a'],
                                   atol=STATE_ATOL)
        np.testing.assert_allclose(_np(state.duals.y).T, g[f's{s}_dual_y'],
                                   atol=STATE_ATOL)
        for gi, gate in enumerate(('i', 'f', 'g', 'o')):
            np.testing.assert_allclose(_np(state.params.wx[gi]),
                                       g[f'w{s}_x2{gate}'], atol=STATE_ATOL)
            np.testing.assert_allclose(_np(state.params.wh[gi]),
                                       g[f'w{s}_h2{gate}'], atol=STATE_ATOL)
        np.testing.assert_allclose(_np(state.params.wy), g[f'w{s}_wy'],
                                   atol=STATE_ATOL)


TURBO = dict(sweep_mode='jacobi', exact_weight_solve=True,
             matmul_precision='default')
JAX_CASES = [
    ('fast', dict(variant='fast')),
    ('no_dual_y', dict(variant='no_dual_y')),
    ('bfloat16', dict(variant='fast', dtype='bfloat16')),
    ('adaptive_rho', dict(variant='fast', adaptive_rho=True)),
    ('jacobi', dict(sweep_mode='jacobi')),
    ('exact', dict(exact_weight_solve=True)),
    ('turbo', TURBO),
    ('auto', dict(AUTO_FIELDS)),
    # I = 130 > 128: the x-side stage takes the blocked solve.
    ('turbo_wide_input', dict(TURBO, input_size=130)),
    # The x-side stage (D = I = 2) takes the exact solve, the h side
    # (D = H = 6) the prox-linear step.
    ('exact_solve_max_dim', dict(exact_weight_solve=True,
                                 exact_solve_max_dim=4)),
    # rho_y 2: rho_y * lambda_max(h_T h_T^T) exceeds both variants'
    # fixed theta, so the Lipschitz safeguard binds (checked below).
    ('wy_lipschitz_fast', dict(wy_lipschitz=True, rho_y=2.0)),
    ('wy_lipschitz_no_dual_y', dict(variant='no_dual_y', wy_lipschitz=True,
                                    rho_y=2.0)),
    ('h_theta', dict(h_theta0=0.02, h_theta_max=4.0)),
    ('adapt_mu_tau', dict(adaptive_rho=True, adapt_mu=1.5, adapt_tau=1.5)),
    ('matmul_precision_high', dict(matmul_precision='high')),
]


def _pset(module_parameter_set, rho_y):
    """The 'Synthetic' set, with rho_y replaced when given."""
    ps = module_parameter_set('Synthetic')
    if rho_y is None:
        return ps
    return type(ps).from_dict({'rho': dict(ps.rho, y=rho_y), 'beta': ps.beta})


@pytest.mark.parametrize('name,cfgkw', JAX_CASES)
def test_torch_step_matches_jax_step(name, cfgkw):
    """3 epochs on Synthetic, each compared: every slab, a, y, the weights
    at atol 1e-4 and rho at rtol 1e-6 (f32, summation order)."""
    cfgkw = dict(cfgkw)
    n_in = cfgkw.pop('input_size', 2)
    rho_y = cfgkw.pop('rho_y', None)
    tx, ty, _, _ = synth(batch=48, seq_len=7, input_size=n_in, output_size=1,
                         val_batch=4, seed=3)
    rng = np.random.default_rng(11)
    hidden = 6
    wx = (rng.standard_normal((4, n_in, hidden)) * 0.5
          * min(1.0, np.sqrt(2 / n_in))).astype(np.float32)
    wh = (rng.standard_normal((4, hidden, hidden)) * 0.4).astype(np.float32)
    wy = (rng.standard_normal((hidden, 1)) * 0.5).astype(np.float32)
    w = {f'x2{g}': wx[k] for k, g in enumerate('ifgo')}
    w.update({f'h2{g}': wh[k] for k, g in enumerate('ifgo')}, wy=wy)

    j_cfg = JConfig(**cfgkw)
    j_state = j_init(j_params_from_dict(w), jnp.asarray(tx),
                     _pset(j_parameter_set, rho_y), j_cfg)
    j_step = j_make_step(j_cfg, donate=False)

    cfg = ADMMConfig(**cfgkw)
    state = init_admm_state(params_from_numpy(wx, wh, wy),
                            torch.from_numpy(tx), _pset(parameter_set, rho_y),
                            cfg)
    step = make_admm_step(cfg)
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    for s in range(3):
        if cfg.wy_lipschitz:
            h_last = state.gates.h[-1]
            lip = float(state.rho.y
                        * torch.linalg.eigvalsh(h_last @ h_last.T)[-1])
            assert lip > rules_for(cfg).wy_theta, (s, lip)
        j_state = j_step(j_state, jnp.asarray(tx), jnp.asarray(ty))
        state = step(state, x, y)
        for k in SLABS:
            np.testing.assert_allclose(
                _np(getattr(state.gates, k)),
                np.asarray(getattr(j_state.gates, k), np.float32),
                atol=1e-4, err_msg=f'{name} step {s} gate {k}')
            np.testing.assert_allclose(
                _np(getattr(state.duals, k)),
                np.asarray(getattr(j_state.duals, k), np.float32),
                atol=1e-4, err_msg=f'{name} step {s} dual {k}')
        np.testing.assert_allclose(_np(state.gates.a),
                                   np.asarray(j_state.gates.a), atol=1e-4)
        np.testing.assert_allclose(_np(state.duals.y),
                                   np.asarray(j_state.duals.y), atol=1e-4)
        for field in ('wx', 'wh', 'wy'):
            np.testing.assert_allclose(
                _np(getattr(state.params, field)),
                np.asarray(getattr(j_state.params, field)), atol=1e-4,
                err_msg=f'{name} step {s} {field}')
        for k in ('i', 'f', 'g', 'o', 'c', 'h', 'y'):
            np.testing.assert_allclose(
                _np(getattr(state.rho, k)),
                np.asarray(getattr(j_state.rho, k)), rtol=1e-6,
                err_msg=f'{name} step {s} rho {k}')


def test_torch_step_seq_len_one():
    """T = 1 has no interior steps: the sweep is the peeled final step."""
    tx, ty, _, _ = synth(batch=16, seq_len=1, input_size=1, val_batch=4)
    rng = np.random.default_rng(2)
    wx = (rng.standard_normal((4, 1, 3)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((4, 3, 3)) * 0.5).astype(np.float32)
    wy = (rng.standard_normal((3, 1)) * 0.5).astype(np.float32)
    w = {f'x2{g}': wx[k] for k, g in enumerate('ifgo')}
    w.update({f'h2{g}': wh[k] for k, g in enumerate('ifgo')}, wy=wy)
    j_state = j_init(j_params_from_dict(w), jnp.asarray(tx),
                     j_parameter_set('Synthetic'), JConfig())
    j_state = j_make_step(JConfig(), donate=False)(
        j_state, jnp.asarray(tx), jnp.asarray(ty))
    state = init_admm_state(params_from_numpy(wx, wh, wy),
                            torch.from_numpy(tx), parameter_set('Synthetic'))
    state = make_admm_step(ADMMConfig())(state, torch.from_numpy(tx),
                                         torch.from_numpy(ty))
    for k in SLABS:
        np.testing.assert_allclose(_np(getattr(state.gates, k)),
                                   np.asarray(getattr(j_state.gates, k)),
                                   atol=1e-5)


@pytest.mark.parametrize('input_size', [1, 2])
def test_torch_kernel_route_matches_scan_loop(monkeypatch, input_size):
    """The step's kernel route (argument slicing, contiguity, reassembly),
    taken on CPU tensors, where the wrapper runs the plain version, agrees
    with the scan-mirroring loop."""
    from admm_lstm_torch.core import step as step_mod
    tx, ty, _, _ = synth(batch=20, seq_len=5, input_size=input_size,
                         val_batch=4)
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    rng = np.random.default_rng(5)
    wx = (rng.standard_normal((4, input_size, 4)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((4, 4, 4)) * 0.4).astype(np.float32)
    wy = (rng.standard_normal((4, 1)) * 0.5).astype(np.float32)
    ps = parameter_set('Synthetic')
    states = {}
    for route in (True, False):
        monkeypatch.setattr(step_mod, '_sweep_uses_kernel',
                            lambda rules, seq_len, device, r=route: r)
        st = init_admm_state(params_from_numpy(wx, wh, wy), x, ps)
        step = make_admm_step(ADMMConfig())
        for _ in range(2):
            st = step(st, x, y)
        states[route] = st
    for k in SLABS:
        np.testing.assert_allclose(_np(getattr(states[True].gates, k)),
                                   _np(getattr(states[False].gates, k)),
                                   atol=1e-6)
        np.testing.assert_allclose(_np(getattr(states[True].duals, k)),
                                   _np(getattr(states[False].duals, k)),
                                   atol=1e-6)


@pytest.mark.parametrize('cfgkw,exc,match', [
    # The legacy variants train through admm_lstm_torch.variants, not the
    # core epoch (as in the JAX package's core/step.rules_for).
    (dict(variant='admm_l'), ValueError, 'admm_l'),
    (dict(variant='admm_s'), ValueError, 'admm_s'),
])
def test_torch_step_unported_configs_raise(cfgkw, exc, match):
    with pytest.raises(exc, match=match):
        make_admm_step(ADMMConfig(**cfgkw))


def test_torch_step_ignores_a_2d_mesh_in_one_process():
    """A (data, model) mesh in the config is api.train_sharded's (and the
    layouts of parallel/sharding.py); one process's epoch ignores it, as
    the JAX package's make_admm_step does."""
    tx, ty, _, _ = synth(batch=16, seq_len=4, input_size=2, val_batch=4)
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    params = params_from_numpy(
        *(np.full(s, 0.1, np.float32) for s in ((4, 2, 3), (4, 3, 3), (3, 1))))
    ps = parameter_set('Synthetic')
    got, want = (make_admm_step(ADMMConfig(mesh_shape=mesh))(
        init_admm_state(params, x, ps), x, y) for mesh in ((2, 2), None))
    for a, b in zip(got.params, want.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize('cfgkw', [dict(sweep_mode='jacobi'),
                                   dict(exact_weight_solve=True)],
                         ids=['jacobi', 'exact_weight_solve'])
def test_torch_step_turbo_leg_configs_run(cfgkw):
    """The configs slice 1 refused now take an epoch."""
    tx, ty, _, _ = synth(batch=16, seq_len=4, input_size=2, val_batch=4)
    x = torch.from_numpy(tx)
    params = params_from_numpy(
        *(np.full(s, 0.1, np.float32) for s in ((4, 2, 3), (4, 3, 3), (3, 1))))
    cfg = ADMMConfig(**cfgkw)
    state = init_admm_state(params, x, parameter_set('Synthetic'), cfg)
    state = make_admm_step(cfg)(state, x, torch.from_numpy(ty))
    assert state.epoch == 1
    assert all(bool(torch.isfinite(s).all()) for s in state.gates)


@pytest.mark.parametrize('input_size', [2, 130])
def test_torch_turbo_kernel_routes_match_plain(monkeypatch, input_size):
    """The step's Jacobi and Cholesky kernel routes (argument slicing,
    contiguity, reassembly), taken on CPU tensors, where the wrappers run
    the plain versions, agree with the plain routes exactly; and the
    kernel route does go through the wrappers.  I = 130 takes the blocked
    solve on the x side."""
    from admm_lstm_torch.core import step as step_mod
    from admm_lstm_torch.kernels import cholesky
    from admm_lstm_torch.kernels import gate_sweep
    from admm_lstm_torch.solvers import blocked_chol, normal_eq
    tx, ty, _, _ = synth(batch=20, seq_len=5, input_size=input_size,
                         val_batch=4)
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    rng = np.random.default_rng(6)
    wx = (rng.standard_normal((4, input_size, 4)) * 0.5
          / np.sqrt(input_size)).astype(np.float32)
    wh = (rng.standard_normal((4, 4, 4)) * 0.4).astype(np.float32)
    wy = (rng.standard_normal((4, 1)) * 0.5).astype(np.float32)
    ps = parameter_set('Synthetic')
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    wrappers = (cholesky.chol_solve, cholesky.chol_inverse,
                gate_sweep.jacobi_sweep)
    before = [w.launches for w in wrappers]
    spy(gate_sweep, 'jacobi_sweep')
    spy(normal_eq, 'chol_solve')
    spy(blocked_chol, 'chol_inverse')
    states = {}
    for route in (True, False):
        calls.clear()
        monkeypatch.setattr(step_mod, '_sweep_uses_kernel',
                            lambda rules, seq_len, device, r=route: r)
        cfg = ADMMConfig.turbo(use_pallas_chol=route)
        st = init_admm_state(params_from_numpy(wx, wh, wy), x, ps, cfg)
        step = make_admm_step(cfg)
        for _ in range(2):
            st = step(st, x, y)
        states[route] = st
        if route:
            assert calls['jacobi_sweep'] == 2
            assert calls['chol_solve'] == (4 if input_size <= 128 else 2)
            assert calls.get('chol_inverse', 0) == (
                0 if input_size <= 128 else 2 * 3)
        else:
            assert calls == {}
    assert [w.launches for w in wrappers] == before   # CPU: no launches
    for k in SLABS:
        assert torch.equal(getattr(states[True].gates, k),
                           getattr(states[False].gates, k))
        assert torch.equal(getattr(states[True].duals, k),
                           getattr(states[False].duals, k))
    for field in ('wx', 'wh', 'wy'):
        assert torch.equal(getattr(states[True].params, field),
                           getattr(states[False].params, field))
