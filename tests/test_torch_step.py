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
from admm_lstm_torch.core.step import make_admm_step
from admm_lstm_torch.data.synthetic import load as synth
from admm_lstm_torch.models.lstm import params_from_dict, params_from_numpy
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig

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


JAX_CASES = [
    ('fast', dict(variant='fast')),
    ('no_dual_y', dict(variant='no_dual_y')),
    ('bfloat16', dict(variant='fast', dtype='bfloat16')),
    ('adaptive_rho', dict(variant='fast', adaptive_rho=True)),
]


@pytest.mark.parametrize('name,cfgkw', JAX_CASES)
def test_torch_step_matches_jax_step(name, cfgkw):
    """3 epochs on Synthetic: every slab, a, y and the weights at 1e-4."""
    tx, ty, _, _ = synth(batch=48, seq_len=7, input_size=2, output_size=1,
                         val_batch=4, seed=3)
    rng = np.random.default_rng(11)
    hidden = 6
    wx = (rng.standard_normal((4, 2, hidden)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((4, hidden, hidden)) * 0.4).astype(np.float32)
    wy = (rng.standard_normal((hidden, 1)) * 0.5).astype(np.float32)
    w = {f'x2{g}': wx[k] for k, g in enumerate('ifgo')}
    w.update({f'h2{g}': wh[k] for k, g in enumerate('ifgo')}, wy=wy)

    j_cfg = JConfig(**cfgkw)
    j_state = j_init(j_params_from_dict(w), jnp.asarray(tx),
                     j_parameter_set('Synthetic'), j_cfg)
    j_step = j_make_step(j_cfg, donate=False)

    cfg = ADMMConfig(**cfgkw)
    state = init_admm_state(params_from_numpy(wx, wh, wy),
                            torch.from_numpy(tx), parameter_set('Synthetic'),
                            cfg)
    step = make_admm_step(cfg)
    x, y = torch.from_numpy(tx), torch.from_numpy(ty)
    for s in range(3):
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


@pytest.mark.parametrize('cfgkw,match', [
    (dict(sweep_mode='jacobi'), 'jacobi'),
    (dict(exact_weight_solve=True), 'exact_weight_solve'),
    (dict(mesh_shape=(2,)), 'mesh_shape'),
    (dict(variant='admm_l'), 'admm_l'),
    (dict(variant='admm_s'), 'admm_s'),
])
def test_torch_step_unported_configs_raise(cfgkw, match):
    with pytest.raises(NotImplementedError, match=match):
        make_admm_step(ADMMConfig(**cfgkw))
