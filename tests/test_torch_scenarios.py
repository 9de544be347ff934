"""The port's scenario batch (api.train_scenarios) against the JAX
package's on the CPU, and the JAX numbers that chip_smoke.py's
`scenarios` phase holds the card to (SCEN_TRAIN, SCEN_VAL, the golden
seed-split inits), recomputed with the JAX package.

Inputs come from numpy; JAX's seed-split initial weights go to the port as
numpy arrays (a torch.Generator cannot reproduce jax.random.split).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from admm_lstm_tpu import ADMMConfig as JConfig  # noqa: E402
from admm_lstm_tpu.api import train_scenarios as j_train_scenarios  # noqa: E402
from admm_lstm_tpu.core.init import init_admm_state as j_init  # noqa: E402
from admm_lstm_tpu.core.step import make_admm_step as j_make_step  # noqa: E402
from admm_lstm_tpu.data.synthetic import load as j_synth  # noqa: E402
from admm_lstm_tpu.data.yahoo_finance import load_scenarios as j_load_scenarios  # noqa: E402
from admm_lstm_tpu.models.lstm import LSTMParams as JParams  # noqa: E402
from admm_lstm_tpu.models.lstm import init_lstm_params as j_init_params  # noqa: E402
from admm_lstm_tpu.models.lstm import mse_loss as j_mse  # noqa: E402
from admm_lstm_tpu.params import parameter_set as j_parameter_set  # noqa: E402
from admm_lstm_torch import api  # noqa: E402
from admm_lstm_torch.core import state as st  # noqa: E402
from admm_lstm_torch.core.step import make_admm_step  # noqa: E402
from admm_lstm_torch.data.yahoo_finance import load_scenarios  # noqa: E402
from admm_lstm_torch.models.lstm import LSTMParams, mse_loss, params_from_numpy  # noqa: E402
from admm_lstm_torch.params import parameter_set  # noqa: E402
from admm_lstm_torch.utils.config import ADMMConfig  # noqa: E402
from admm_lstm_torch.utils.device import NoCudaDeviceError  # noqa: E402

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

# f32, summation order: the 15-epoch Synthetic trajectories agree within
# ~1.2e-6 relative and the weights within ~1.3e-6.
RTOL = 1e-5
ATOL = 1e-5


def _jax_inits(n, input_size, hidden, output_size, seed=0):
    """JAX's seed-split inits as numpy (wx, wh, wy) with a leading S axis,
    as its train_scenarios draws them."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    p = jax.vmap(lambda k: j_init_params(k, input_size, hidden,
                                         output_size))(keys)
    return tuple(np.asarray(a) for a in p)


@pytest.fixture(scope='module')
def synthetic_scenarios():
    """3 Synthetic scenarios, as tests/test_sharding.py's
    test_train_scenarios_vmapped makes them."""
    scen = [j_synth(batch=32, seq_len=5, input_size=1, output_size=1,
                    val_batch=8, seed=s) for s in range(3)]
    return tuple(np.stack([s[k] for s in scen]) for k in range(4))


@pytest.mark.parametrize('variant', ['no_dual_y', 'fast'])
def test_torch_train_scenarios_matches_jax(synthetic_scenarios, variant):
    xs, ys, vxs, vys = synthetic_scenarios
    kw = dict(variant=variant, epochs=15, hidden_size=5, wy_lipschitz=True)
    ref = j_train_scenarios(xs, ys, vxs, vys, j_parameter_set('Synthetic'),
                            JConfig(**kw))
    got = api.train_scenarios(
        xs, ys, vxs, vys, parameter_set('Synthetic'), ADMMConfig(**kw),
        params=params_from_numpy(*_jax_inits(3, 1, 5, 1)), device='cpu')
    assert got['name'] == ref['name']
    assert got['train_loss'].shape == got['val_loss'].shape == (3, 16)
    np.testing.assert_allclose(got['train_loss'], ref['train_loss'],
                               rtol=RTOL)
    np.testing.assert_allclose(got['val_loss'], ref['val_loss'], rtol=RTOL)
    for field in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(getattr(got['params'], field).numpy(),
                                   np.asarray(getattr(ref['params'], field)),
                                   atol=ATOL, err_msg=field)
    assert [s.epoch for s in got['state']] == [15, 15, 15]
    for s, state in enumerate(got['state']):
        torch.testing.assert_close(state.params.wy, got['params'].wy[s])
    assert got['seconds'] > 0


def test_torch_train_scenarios_default_init(synthetic_scenarios):
    """Without params=, scenario s draws from its own generator seeded by
    (config.seed, s): the run repeats, and the scenarios start apart."""
    xs, ys, vxs, vys = synthetic_scenarios
    cfg = ADMMConfig(epochs=2, hidden_size=3)
    runs = [api.train_scenarios(xs, ys, vxs, vys, parameter_set('Synthetic'),
                                cfg, device='cpu') for _ in range(2)]
    np.testing.assert_array_equal(runs[0]['val_loss'], runs[1]['val_loss'])
    g0 = api.scenario_generator(0, 0)
    g1 = api.scenario_generator(0, 1)
    assert not torch.equal(torch.randn(4, generator=g0),
                           torch.randn(4, generator=g1))
    first = [torch.randn(3, generator=api.scenario_generator(0, 0))
             for _ in range(2)]
    torch.testing.assert_close(first[0], first[1])


def test_torch_train_scenarios_needs_card_unless_cpu(synthetic_scenarios):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    xs, ys, vxs, vys = synthetic_scenarios
    with pytest.raises(NoCudaDeviceError):
        api.train_scenarios(xs, ys, vxs, vys, parameter_set('Synthetic'),
                            ADMMConfig(epochs=1, hidden_size=3))


def test_torch_scenario_golden_is_jax_seed_split_init():
    g = np.load(chip_smoke.SCEN_INIT)
    wx, wh, wy = _jax_inits(chip_smoke.SCEN_COUNT, 1, 10, 1)
    for k, q in enumerate('ifgo'):
        np.testing.assert_array_equal(g[f'w0_x2{q}'], wx[:, k])
        np.testing.assert_array_equal(g[f'w0_h2{q}'], wh[:, k])
    np.testing.assert_array_equal(g['w0_wy'], wy)


def _golden_numpy_params():
    """The golden inits as numpy (wx, wh, wy) with a leading S axis."""
    g = np.load(chip_smoke.SCEN_INIT)
    gates = lambda side: np.stack([g[f'w0_{side}2{q}'] for q in 'ifgo'], 1)
    return gates('x'), gates('h'), g['w0_wy']


def _scenario_config(jax_package):
    cls = JConfig if jax_package else ADMMConfig
    return cls(variant='fast', hidden_size=10, epochs=chip_smoke.SCEN_EPOCHS,
               seed=0, wy_lipschitz=True)


def test_torch_scenario_reference_constants():
    """SCEN_TRAIN and SCEN_VAL are the JAX package's train_scenarios on
    chip_smoke.py's config (the golden inits are JAX's own draw, held
    above); the loaders agree."""
    data = j_load_scenarios(chip_smoke.SCEN_COUNT, seed=0)
    for a, b in zip(data, load_scenarios(chip_smoke.SCEN_COUNT, seed=0)):
        np.testing.assert_array_equal(a, b)
    ref = j_train_scenarios(*data, j_parameter_set('YahooFinance'),
                            _scenario_config(True))
    np.testing.assert_allclose(ref['train_loss'], chip_smoke.SCEN_TRAIN,
                               rtol=RTOL)
    np.testing.assert_allclose(ref['val_loss'], chip_smoke.SCEN_VAL,
                               rtol=RTOL)


def _carry(j_state):
    """A JAX ADMMState as the port's, on the CPU."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return st.ADMMState(params=LSTMParams(*map(t, j_state.params)),
                        gates=st.GateSlabs(*map(t, j_state.gates)),
                        duals=st.DualSlabs(*map(t, j_state.duals)),
                        rho=st.Penalties(*map(t, j_state.rho)),
                        beta=st.Ridges(*map(t, j_state.beta)),
                        epoch=int(j_state.epoch))


# (start epoch, rtol of the validation loss, tolerance of each leaf as a
# share of its scale).  Epoch 27 is scenario 2's jump (val 0.004 -> 0.96):
# that one epoch amplifies the packages' rounding differences, measured
# 1.9e-5 on the validation loss and 4.3e-4 of its scale on the g slab
# (9.1e-6 on the weights), against at most 6.5e-6 and 7.1e-7 at epochs 11
# and 26.
EPOCH_CASES = [(10, 1e-5, 1e-5), (25, 1e-5, 1e-5), (26, 1e-4, 1e-3)]


@pytest.mark.parametrize('start,val_rtol,leaf_tol', EPOCH_CASES)
def test_torch_scenario_one_epoch_matches_jax(start, val_rtol, leaf_tol):
    """Scenario 2 of chip_smoke.py's run: one epoch from JAX's state after
    `start` epochs, in both packages.  The validation loss within
    `val_rtol`, and every leaf within `leaf_tol` of its scale (max |x|; a
    dual's: max |lambda| + rho max |its primal|).  The 30-epoch runs part
    (chip_smoke.SCEN_RTOL says how far); single epochs agree."""
    s = 2
    xs, ys, vxs, vys = j_load_scenarios(chip_smoke.SCEN_COUNT, seed=0)
    x, y = jnp.asarray(xs[s]), jnp.asarray(ys[s])
    cfg = _scenario_config(True)
    j_step = j_make_step(cfg, donate=False)
    j_state = j_init(JParams(*(jnp.asarray(a[s])
                               for a in _golden_numpy_params())), x,
                     j_parameter_set('YahooFinance'), cfg)
    for _ in range(start):
        j_state = j_step(j_state, x, y)
    want = j_step(j_state, x, y)
    got = make_admm_step(_scenario_config(False))(
        _carry(j_state), torch.from_numpy(xs[s]), torch.from_numpy(ys[s]))
    want_val = float(j_mse(want.params, jnp.asarray(vxs[s]),
                           jnp.asarray(vys[s])))
    got_val = float(mse_loss(got.params, torch.from_numpy(vxs[s]),
                             torch.from_numpy(vys[s])))
    np.testing.assert_allclose(got_val, want_val, rtol=val_rtol)
    if start + 1 == chip_smoke.SCEN_JUMP_FROM:
        assert min(got_val, want_val) > chip_smoke.SCEN_JUMP
    amax = lambda a: float(np.abs(np.asarray(a)).max())
    for group in ('params', 'gates', 'duals'):
        for name, w, g in zip(getattr(want, group)._fields,
                              getattr(want, group), getattr(got, group)):
            scale = amax(w)
            if group == 'duals':
                primal = 'a' if name == 'y' else name
                scale += (float(getattr(want.rho, name))
                          * amax(getattr(want.gates, primal)))
            err = amax(np.asarray(w) - g.numpy())
            assert err <= leaf_tol * scale, (group, name, err, scale)


def test_torch_scenario_cpu_run_passes_the_card_gate():
    """The port's own CPU run of chip_smoke.py's scenario config passes
    the gate the card's run must pass (_hold_scenarios)."""
    data = load_scenarios(chip_smoke.SCEN_COUNT, seed=0)
    res = api.train_scenarios(*data, parameter_set('YahooFinance'),
                              _scenario_config(False),
                              params=params_from_numpy(
                                  *_golden_numpy_params()),
                              device='cpu')
    report = chip_smoke._hold_scenarios(res['train_loss'], res['val_loss'])
    print(report)
    assert [r['jax_jump'] for r in report] == [False, False, True, False]


def test_torch_scenario_gate_refuses_a_control():
    """The gate has teeth after its strict epochs: scenario 0 of the port's
    CPU run with its weights rounded to float16 once after epoch
    SCEN_STRICT_EPOCHS (a relative change of at most 4.9e-4 per weight) is
    refused by the hold of the
    epochs before a jump (SCEN_HELD_RTOL), not by the strict one; the
    other scenarios are JAX's own numbers."""
    from admm_lstm_torch.core.init import init_admm_state
    from admm_lstm_torch.core.step import rules_for, run_epochs
    from admm_lstm_torch.models.lstm import train_val_mse_im
    xs, ys, vxs, vys = (torch.from_numpy(a[:1]) for a in
                        load_scenarios(chip_smoke.SCEN_COUNT, seed=0))
    cfg = _scenario_config(False)
    rules = rules_for(cfg)
    x_im, y_im, xall_im, vy_im = api.batch_minor(xs[0], ys[0], vxs[0],
                                                 vys[0])
    init = params_from_numpy(*(a[0] for a in _golden_numpy_params()))
    state = init_admm_state(init, xs[0], parameter_set('YahooFinance'), cfg)
    first = train_val_mse_im(state.params, xall_im, y_im, vy_im)
    k = chip_smoke.SCEN_STRICT_EPOCHS
    state, head = run_epochs(state, k, x_im, y_im, xall_im, vy_im, rules)
    state = state._replace(params=LSTMParams(*(w.half().float()
                                               for w in state.params)))
    state, tail = run_epochs(state, chip_smoke.SCEN_EPOCHS - k, x_im, y_im,
                             xall_im, vy_im, rules)
    train = np.array(chip_smoke.SCEN_TRAIN)
    val = np.array(chip_smoke.SCEN_VAL)
    train[0] = torch.cat([first[0][None], head['train_loss'],
                          tail['train_loss']]).numpy()
    val[0] = torch.cat([first[1][None], head['val_loss'],
                        tail['val_loss']]).numpy()
    gap = chip_smoke._scenario_report(train, val)[0]['largest_gap_held']
    print(f'float16 control, scenario 0: largest gap before a jump {gap}')
    assert gap > 10 * chip_smoke.SCEN_HELD_RTOL
    with pytest.raises(AssertionError, match=r'scenario 0 (train|val)\n'):
        chip_smoke._hold_scenarios(train, val)
