"""The port's stacked N-layer variant (admm_lstm_torch/variants/stacked.py)
against the JAX package's, on the CPU.  Inputs are the JAX package's
seeded synthetic problem (B 48, T 6, I 2); the weights are JAX's
`init_stacked(PRNGKey(0))`, carried across as numpy arrays."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu import ADMMConfig as JConfig
from admm_lstm_tpu.ckpt.checkpoint import load_model as j_load_model
from admm_lstm_tpu.ckpt.checkpoint import save_model as j_save_model
from admm_lstm_tpu.core.step import rules_for as j_rules_for
from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.params import parameter_set as j_parameter_set
from admm_lstm_tpu.variants import stacked as js
from admm_lstm_torch.ckpt.checkpoint import load_model, save_model
from admm_lstm_torch.core.step import rules_for
from admm_lstm_torch.params import parameter_set
from admm_lstm_torch.utils.config import ADMMConfig
from admm_lstm_torch.utils.device import NoCudaDeviceError
from admm_lstm_torch.variants import stacked as ts

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32: the same math in another summation order (one epoch, and the
# trajectories over a few epochs); the pieces alone and the forward.
EPOCH_ATOL = 1e-4
PIECE_ATOL = 1e-5
TRAJ_RTOL = 1e-4
DEPTHS = {2: (6, 5), 3: (6, 5, 4)}


@pytest.fixture(scope='module')
def data():
    return synth(batch=48, seq_len=6, input_size=2, output_size=1,
                 val_batch=8)


def weights_of(j_params):
    """A JAX StackedParams as the .npz-named numpy arrays."""
    w = {}
    for k, layer in enumerate(j_params.layers):
        for gi, g in enumerate('ifgo'):
            w[f'l{k}_x2{g}'] = np.array(layer.wx[gi])
            w[f'l{k}_h2{g}'] = np.array(layer.wh[gi])
        w[f'l{k}_wy'] = np.array(layer.wy)
    w['wy'] = np.array(j_params.wy)
    return w


def both_params(hiddens, input_size=2, seed=0):
    jp = js.init_stacked(jax.random.PRNGKey(seed), input_size, hiddens, 1)
    return jp, ts.stacked_params_from_dict(weights_of(jp))


def leaves(state):
    """(name, array) of every leaf of a stacked state, either package."""
    out = []
    for k, layer in enumerate(state.params.layers):
        out += [(f'layer{k}.{f}', getattr(layer, f)) for f in
                ('wx', 'wh', 'wy')]
        out += [(f'gates{k}.{f}', getattr(state.gates[k], f)) for f in
                'ifgocha']
        out += [(f'duals{k}.{f}', getattr(state.duals[k], f)) for f in
                'ifgochy']
    out.append(('wy', state.params.wy))
    for k in range(len(state.zs)):
        out += [(f'z{k + 1}', state.zs[k]), (f'zdual{k + 1}',
                                              state.zduals[k])]
    out += [(f'rho.{f}', getattr(state.rho, f)) for f in 'ifgochy']
    out.append(('rho_z', state.rho_z))
    return [(n, np.asarray(a)) for n, a in out]


def assert_states_close(got, ref, atol):
    got, ref = leaves(got), leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, a), (_, b) in zip(got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize('depth', sorted(DEPTHS))
def test_torch_stacked_forward_and_state_match_jax(data, depth):
    tx = data[0]
    jp, tp = both_params(DEPTHS[depth])
    np.testing.assert_allclose(
        ts.stacked_forward(tp, torch.from_numpy(tx)).numpy(),
        np.asarray(js.stacked_forward(jp, jnp.asarray(tx))), atol=PIECE_ATOL)
    np.testing.assert_allclose(
        float(ts.stacked_mse_loss(tp, torch.from_numpy(tx),
                                  torch.from_numpy(data[1]))),
        float(js.stacked_mse_loss(jp, jnp.asarray(tx), jnp.asarray(data[1]))),
        rtol=1e-5)
    ref = js.init_stacked_state(jp, jnp.asarray(tx),
                                j_parameter_set('Stacked'), JConfig())
    got = ts.init_stacked_state(tp, torch.from_numpy(tx),
                                parameter_set('Stacked'), ADMMConfig())
    assert got.epoch == 0
    assert_states_close(got, ref, PIECE_ATOL)
    # The seeded `a` is the forward's prediction, batch-minor.
    np.testing.assert_allclose(got.gates2.a.numpy(),
                               ts.stacked_forward(tp, torch.from_numpy(tx))
                               .numpy().T, atol=1e-6)
    assert float(got.gates1.h[0].abs().max()) == 0.0


def test_torch_four_layer_state_shapes(data):
    """As tests/test_stacked.py::test_four_layer_state_shapes."""
    tx = torch.from_numpy(data[0])
    _, tp = both_params((6, 5, 4, 3), seed=1)
    state = ts.init_stacked_state(tp, tx, parameter_set('Stacked'),
                                  ADMMConfig())
    assert len(state.gates) == 4 and len(state.zs) == 3
    t_plus1 = tx.shape[1] + 1
    assert state.zs[0].shape == (t_plus1, 4, 5, 48)
    assert state.zs[2].shape == (t_plus1, 4, 3, 48)
    np.testing.assert_allclose(torch.sigmoid(state.zs[0][1, 0]).numpy(),
                               state.gates[1].i[1].numpy(), atol=1e-5)


@pytest.mark.parametrize('decay', [1.0, 0.9])
@pytest.mark.parametrize('variant', ['fast', 'no_dual_y'])
@pytest.mark.parametrize('depth', sorted(DEPTHS))
def test_torch_stacked_epoch_matches_jax(data, depth, variant, decay):
    """One epoch: every leaf of the state against JAX's
    make_stacked_step(donate=False)."""
    tx, ty = data[0], data[1]
    jp, tp = both_params(DEPTHS[depth])
    jcfg = JConfig(variant=variant, stacked_dual_decay=decay)
    cfg = ADMMConfig(variant=variant, stacked_dual_decay=decay)
    assert rules_for(cfg).stacked_dual_decay == decay
    ref = js.init_stacked_state(jp, jnp.asarray(tx),
                                j_parameter_set('Stacked'), jcfg)
    ref = js.make_stacked_step(jcfg, donate=False)(ref, jnp.asarray(tx),
                                                   jnp.asarray(ty))
    got = ts.init_stacked_state(tp, torch.from_numpy(tx),
                                parameter_set('Stacked'), cfg)
    got = ts.make_stacked_step(cfg)(got, torch.from_numpy(tx),
                                    torch.from_numpy(ty))
    assert got.epoch == 1
    assert_states_close(got, ref, EPOCH_ATOL)


def test_torch_stacked_dual_decay_scales_the_ascent(data):
    """decay multiplies every ascent, the z-duals' included: the first
    epoch's duals at 0.9 are 0.9 times those at 1.0 (duals start at
    zero), except the lower layers' h duals, which pass through."""
    tx, ty = (torch.from_numpy(a) for a in data[:2])
    _, tp = both_params(DEPTHS[3])
    states = {}
    for decay in (1.0, 0.9):
        cfg = ADMMConfig(stacked_dual_decay=decay)
        st = ts.init_stacked_state(tp, tx, parameter_set('Stacked'), cfg)
        states[decay] = ts.make_stacked_step(cfg)(st, tx, ty)
    exact, damped = states[1.0], states[0.9]
    for k in range(3):
        for f in 'ifgoc':
            np.testing.assert_allclose(getattr(damped.duals[k], f).numpy(),
                                       0.9 * getattr(exact.duals[k], f)
                                       .numpy(), rtol=1e-5, atol=1e-9)
    for a, b in zip(damped.zduals, exact.zduals):
        np.testing.assert_allclose(a.numpy(), 0.9 * b.numpy(), rtol=1e-5,
                                   atol=1e-9)
    for k in range(2):
        assert float(damped.duals[k].h.abs().max()) == 0.0
    top = damped.duals[2].h
    assert float(top[:-1].abs().max()) == 0.0
    np.testing.assert_allclose(top[-1].numpy(),
                               0.9 * exact.duals[2].h[-1].numpy(), rtol=1e-5,
                               atol=1e-9)


@pytest.fixture(scope='module')
def seeded(data):
    """The depth-3 state after one JAX epoch (nonzero duals and z-duals),
    in both packages."""
    tx, ty = data[0], data[1]
    jp, _ = both_params(DEPTHS[3])
    jcfg = JConfig()
    st = js.init_stacked_state(jp, jnp.asarray(tx),
                               j_parameter_set('Stacked'), jcfg)
    st = js.make_stacked_step(jcfg, donate=False)(st, jnp.asarray(tx),
                                                  jnp.asarray(ty))
    got = ts.init_stacked_state(
        ts.stacked_params_from_dict(weights_of(st.params)),
        torch.from_numpy(tx), parameter_set('Stacked'), ADMMConfig())
    t = lambda a: torch.from_numpy(np.array(a))
    from admm_lstm_torch.core.state import DualSlabs, GateSlabs
    got = got._replace(
        gates=tuple(GateSlabs(*(t(a) for a in g)) for g in st.gates),
        duals=tuple(DualSlabs(*(t(a) for a in d)) for d in st.duals),
        zs=tuple(t(z) for z in st.zs), zduals=tuple(t(z) for z in st.zduals))
    return st, got


def test_torch_layer0_weight_phase_matches_jax(data, seeded):
    """JAX resolves use_pallas_chol='auto' to its plain solve on the CPU;
    the port's chol_solve runs its plain version on CPU tensors."""
    ref_state, got_state = seeded
    x_im = np.ascontiguousarray(np.transpose(data[0], (1, 2, 0)))
    ref = js._layer0_weight_phase(
        jnp.asarray(x_im), ref_state.gates[0], ref_state.duals[0],
        ref_state.params.layers[0], ref_state.rho, ref_state.beta,
        j_rules_for(JConfig()))
    got = ts._layer0_weight_phase(
        torch.from_numpy(x_im), got_state.gates[0], got_state.duals[0],
        got_state.params.layers[0], got_state.rho, got_state.beta,
        rules_for(ADMMConfig()))
    for f in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   atol=PIECE_ATOL, err_msg=f)


@pytest.mark.parametrize('k', [1, 2])
def test_torch_upper_weight_solve_matches_jax(seeded, k):
    ref_state, got_state = seeded
    ref = js._upper_weight_solve(
        ref_state.gates[k - 1].h[1:], ref_state.gates[k].h[:-1],
        ref_state.zs[k - 1], ref_state.zduals[k - 1],
        ref_state.params.layers[k], ref_state.rho_z, ref_state.beta,
        jax.lax.Precision.HIGHEST)
    got = ts._upper_weight_solve(
        got_state.gates[k - 1].h[1:], got_state.gates[k].h[:-1],
        got_state.zs[k - 1], got_state.zduals[k - 1],
        got_state.params.layers[k], got_state.rho_z, got_state.beta)
    for f in ('wx', 'wh'):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   atol=PIECE_ATOL, err_msg=f)


def test_torch_z_prox_update_matches_jax():
    rng = np.random.default_rng(3)
    z_old, target, v = (rng.standard_normal((4, 5, 48)).astype(np.float32)
                        for _ in range(3))
    rho_g4 = np.asarray([1.0, 0.5, 2.0, 1.5], np.float32)[:, None, None]
    is_tanh = np.asarray([False, False, True, False])[:, None, None]
    args = (z_old, target, v, rho_g4, np.float32(0.7), is_tanh,
            np.float32(0.3))
    ref = js._z_prox_update(*(jnp.asarray(a) for a in args))
    got = ts._z_prox_update(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=PIECE_ATOL)


def test_torch_stacked_weight_phase_timestep_alignment(data):
    """As tests/test_stacked.py: at epoch 0 the slabs satisfy
    z_t = wx h_{k-1,t} + wh h_{k,t-1} exactly, so the upper solve against
    the same-t rows h[1:] below and the shifted own rows h[:-1] stays at
    the init weights; the shifted rows below would not."""
    _, tp = both_params(DEPTHS[2])
    state = ts.init_stacked_state(tp, torch.from_numpy(data[0]),
                                  parameter_set('Stacked'), ADMMConfig())
    layer = state.params.layers[1]
    solved = ts._upper_weight_solve(
        state.gates[0].h[1:], state.gates[1].h[:-1], state.zs[0],
        state.zduals[0], layer, state.rho_z, state.beta)
    np.testing.assert_allclose(solved.wx.numpy(), layer.wx.numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(solved.wh.numpy(), layer.wh.numpy(),
                               atol=5e-3)
    shifted = ts._upper_weight_solve(
        state.gates[0].h[:-1], state.gates[1].h[:-1], state.zs[0],
        state.zduals[0], layer, state.rho_z, state.beta)
    assert float((shifted.wx - layer.wx).abs().max()) > 5e-3


@pytest.mark.parametrize('depth', sorted(DEPTHS))
def test_torch_train_stacked_trajectory_matches_jax(data, depth):
    """5 epochs of train_stacked: both losses within 1e-4 relative, the
    same best epoch, and the returned iterate JAX's."""
    tx, ty, vx, vy = data
    jp, tp = both_params(DEPTHS[depth])
    ref = js.train_stacked(tx, ty, vx, vy, j_parameter_set('Stacked'),
                           JConfig(epochs=5), hiddens=DEPTHS[depth],
                           log_every=2)
    got = ts.train_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                           ADMMConfig(epochs=5), log_every=2, params=tp,
                           device='cpu')
    np.testing.assert_allclose(got['train_loss'], ref['train_loss'],
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'],
                               rtol=TRAJ_RTOL)
    assert got['best_epoch'] == ref['best_epoch']
    assert got['name'] == ref['name']
    np.testing.assert_allclose(got['params'].wy.numpy(),
                               np.asarray(ref['params'].wy), atol=EPOCH_ATOL)
    assert got['state'].epoch == 5 and got['seconds'] > 0


def test_torch_train_stacked_cadence_invariant(data):
    """As tests/test_stacked.py::test_stacked_chunked_loop_cadence_invariant:
    the chunks the log cadence makes change no loss, no best epoch and no
    bit of the returned iterate, which is the best-validation one."""
    tx, ty, vx, vy = data
    runs = [ts.train_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                             ADMMConfig(epochs=21), hiddens=(5, 5),
                             log_every=le, device='cpu') for le in (0, 4)]
    a, b = runs
    assert a['val_loss'] == b['val_loss']
    assert a['best_epoch'] == b['best_epoch']
    for x, y in zip(a['params'].tensors(), b['params'].tensors()):
        assert torch.equal(x, y)
    got = float(ts.stacked_mse_loss(a['params'], torch.from_numpy(vx),
                                    torch.from_numpy(vy)))
    best = a['best_epoch']
    np.testing.assert_allclose(got, a['val_loss'][best], rtol=1e-5)
    assert a['val_loss'][best] == min(a['val_loss'])


@pytest.mark.parametrize('case,want', [('epoch0', 0), ('interior', 3),
                                       ('nonfinite', 3)])
def test_torch_train_stacked_returns_its_argmin_iterate(data, case, want):
    """'best_epoch' is the argmin of the run's own 'val_loss' (the
    nan-argmin where the run diverges) and 'params' are that epoch's
    weights, bit-equal to a run of 'best_epoch' epochs alone (the initial
    weights at epoch 0).  Against negated validation targets training
    only moves away (best at epoch 0); at rho_y x 1000 the run jumps at
    epoch 4 (interior) and then diverges (nonfinite)."""
    from admm_lstm_torch.utils.config import ParameterSet
    tx, ty, vx, vy = data
    _, tp = both_params(DEPTHS[2])
    base = parameter_set('Stacked')
    rho = dict(base.rho)
    if case == 'epoch0':
        vy = -vy
    else:
        rho['y'] *= 1000
    pset = ParameterSet(rho=rho, beta=dict(base.beta))

    def run(epochs, track_best):
        return ts.train_stacked(tx, ty, vx, vy, pset,
                                ADMMConfig(epochs=epochs), log_every=0,
                                track_best=track_best, params=tp,
                                device='cpu')

    res = run({'epoch0': 6, 'interior': 4, 'nonfinite': 8}[case], True)
    assert res['best_epoch'] == want
    assert want == int(np.nanargmin(res['val_loss']))
    assert np.isfinite(res['val_loss']).all() == (case != 'nonfinite')
    alone = run(want, False)['final_params']
    for a, b in zip(res['params'].tensors(), alone.tensors()):
        assert torch.equal(a, b)


def test_torch_stacked_admm_converges(data):
    """As tests/test_stacked.py::test_stacked_admm_converges, 60 epochs."""
    tx, ty = (torch.from_numpy(a) for a in data[:2])
    cfg = ADMMConfig()
    _, tp = both_params(DEPTHS[2])
    state = ts.init_stacked_state(tp, tx, parameter_set('Stacked'), cfg)
    step = ts.make_stacked_step(cfg)
    l0 = float(ts.stacked_mse_loss(state.params, tx, ty))
    for _ in range(60):
        state = step(state, tx, ty)
    l1 = float(ts.stacked_mse_loss(state.params, tx, ty))
    assert np.isfinite(l1) and l1 < 0.5 * l0, (l0, l1)
    for g in state.gates:
        assert float(g.h.abs().max()) < 1.5


def test_torch_stacked_init_draws_from_the_generator():
    a = ts.init_stacked(torch.Generator().manual_seed(5), 3, (4, 2), 1)
    b = ts.init_stacked(torch.Generator().manual_seed(5), 3, (4, 2), 1)
    assert [tuple(w.shape) for w in a.tensors()] == [
        (4, 3, 4), (4, 4, 4), (4, 1), (4, 4, 2), (4, 2, 2), (2, 1), (2, 1)]
    assert all(torch.equal(x, y) for x, y in zip(a.tensors(), b.tensors()))
    assert ts.init_stacked_params(torch.Generator().manual_seed(5), 3, 4, 2,
                                  1).layer2.hidden_size == 2
    with pytest.raises(ValueError, match='layer'):
        ts.init_stacked(torch.Generator(), 3, (), 1)


@pytest.mark.parametrize('depth', sorted(DEPTHS))
def test_torch_stacked_npz_passes_between_packages(tmp_path, data, depth):
    """A stacked .npz from either package loads in the other: the same
    keys and equal arrays."""
    jp, _ = both_params(DEPTHS[depth], seed=2)
    j_path = j_save_model('from-jax', jp, save_dir=str(tmp_path))
    got = load_model(j_path, device='cpu')
    assert isinstance(got, ts.StackedParams)
    for a, b in zip(got.tensors(), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    tp = ts.init_stacked(torch.Generator().manual_seed(2), 2, DEPTHS[depth],
                         1)
    path = save_model('from-torch', tp, save_dir=str(tmp_path))
    with np.load(path) as a, np.load(j_path) as b:
        assert sorted(a.files) == sorted(b.files)
    loaded = j_load_model(path)
    for a, b in zip(tp.tensors(), jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = load_model(save_model('again', load_model(path, device='cpu'),
                                  save_dir=str(tmp_path)), device='cpu')
    assert all(torch.equal(a, b) for a, b in zip(again.tensors(),
                                                 tp.tensors()))
    np.testing.assert_allclose(
        np.asarray(js.stacked_forward(loaded, jnp.asarray(data[0]))),
        ts.stacked_forward(tp, torch.from_numpy(data[0])).numpy(),
        atol=1e-6)


def test_torch_stacked_golden_inits_load():
    """The committed JAX seed-0 inits load as StackedParams of the bench
    widths (tests/test_torch_chip_reference.py holds them to JAX)."""
    for name, widths in (('8x8', (8, 8)), ('8x8x8', (8, 8, 8))):
        params = load_model(os.path.join(
            ROOT, 'tests', 'golden', f'torch_stacked_init_{name}.npz'),
            device='cpu')
        assert tuple(lp.hidden_size for lp in params.layers) == widths
        assert params.layers[0].input_size == 1
        assert tuple(params.wy.shape) == (8, 1)


def test_torch_stacked_entry_points_need_a_card(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    from admm_lstm_torch import api
    tx, ty, vx, vy = data
    with pytest.raises(NoCudaDeviceError):
        ts.train_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                         ADMMConfig(epochs=1))
    with pytest.raises(NoCudaDeviceError):
        api.train_best_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                               ADMMConfig(epochs=1))
    _, tp = both_params(DEPTHS[2])
    path = save_model('m', tp, save_dir=str(tmp_path))
    with pytest.raises(NoCudaDeviceError):
        load_model(path)


def test_torch_train_stacked_refuses_mismatched_widths(data):
    tx, ty, vx, vy = data
    _, tp = both_params(DEPTHS[2])
    with pytest.raises(ValueError, match='hiddens'):
        ts.train_stacked(tx, ty, vx, vy, parameter_set('Stacked'),
                         ADMMConfig(epochs=1), hiddens=(6, 6), params=tp,
                         device='cpu')


def _cli(args, cwd):
    import subprocess
    import sys
    env = dict(os.environ, ADMM_TORCH_NO_FILELOG='1', PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, '-m', 'admm_lstm_torch.cli', *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_torch_cli_layers_run(tmp_path):
    """--layers 2 trains the stacked variant; the losses fall."""
    import re
    proc = _cli(['--cpu', '-y', '-d', 'GoogleStock', '-e', '2', '--layers',
                 '2', '--hidden', '8', '--no-plot'], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '2-layer ADMM (8x8)' in proc.stdout
    # The initial loss line, then the run loop's line after each epoch.
    train = [float(v) for v in re.findall(
        r'(?:train|Training:) ([0-9.]+) \|', proc.stdout)]
    assert len(train) == 3 and train[2] < train[0], proc.stdout


def test_torch_cli_layers_refuses_legacy_variants():
    from admm_lstm_torch.cli import main
    assert main(['--cpu', '-y', '-e', '1', '--no-plot', '--layers', '2',
                 '--variant', 'admm_l']) == 1


def test_torch_cli_layers_hidden2_and_preset():
    """--hidden2 sets the upper widths; --preset best runs
    train_best_stacked."""
    from admm_lstm_torch.cli import main
    args = ['--cpu', '-y', '-d', 'Synthetic', '-nt', '48', '-nv', '8',
            '-e', '2', '--hidden', '4', '--no-plot']
    assert main([*args, '--layers', '3', '--hidden2', '3']) == 0
    assert main([*args, '--layers', '2', '--preset', 'best']) == 0
