"""The port's ADMM-LSTM-S (admm_lstm_torch/variants/admm_s.py) against the
JAX package's, on the CPU.  Inputs are the JAX package's seeded synthetic
problem (B 24, I 2, H 4 at T 2, 3 and 6); states carried across are a JAX
ADMMSState after one JAX epoch, converted with `admm_s_state_from_numpy`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.variants import admm_s as js_mod
from admm_lstm_torch.data import load_dataset
from admm_lstm_torch.data.admm_s_cache import load_admm_s_cache
from admm_lstm_torch.utils.device import NoCudaDeviceError
from admm_lstm_torch.variants import admm_s as ts_mod

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
# f32: the same math in another summation order; each leaf of one epoch
# within STEP_RTOL of its scale, trajectories at TRAJ_RTOL.  A leaf's
# scale is max |x|; for a dual, max |lambda| + rho max |its primal at
# T-1| (lambda + rho (primal - target) sums terms of the primal's size
# that nearly cancel: the duals are ~1e-7 after two epochs), the primal
# taken from a forward pass with the new weights.
STEP_RTOL = 1e-5
TRAJ_RTOL = 1e-5
DUAL_OF = {'lam_z': ('z', 'rho_z'), 'lam_g': ('gate', 'rho_g'),
           'lam9': ('c', 'rho9'), 'lam10': ('h', 'rho10'),
           'lam11': ('y', 'rho11')}


def _data(seq_len, batch=24):
    return synth(batch=batch, seq_len=seq_len, input_size=2, output_size=1,
                 val_batch=8)


def _init_state(seq_len, hidden=4):
    tx, ty, _, _ = _data(seq_len)
    w, u, b, wy, by = js_mod.init_weights_like_reference(0, 2, hidden, 1)
    zeros4 = jnp.zeros((4, tx.shape[0], hidden), jnp.float32)
    state = js_mod.ADMMSState(
        w=w, u=u, b=b, wy=wy, by=by, lam_z=zeros4, lam_g=zeros4,
        lam9=zeros4[0], lam10=zeros4[0],
        lam11=jnp.zeros((tx.shape[0], 1), jnp.float32),
        epoch=jnp.asarray(0, jnp.int32))
    return state, tx, ty


@pytest.mark.parametrize('seed,shape', [(0, (1, 10, 1)), (5, (3, 4, 2))])
def test_torch_admm_s_init_bit_equal(seed, shape):
    """Both packages draw the reference's 14 unscaled torch.randn tensors,
    biases included, in its order."""
    want = js_mod.init_weights_like_reference(seed, *shape)
    got = ts_mod.init_weights_like_reference(seed, *shape)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize('seq_len', [2, 3, 6])
def test_torch_admm_s_step_matches_jax(seq_len):
    """T = 2 and 3 take the peeled timesteps only; T = 6 the interior ones
    too."""
    rules = js_mod.ADMMSRules()
    state, tx, ty = _init_state(seq_len)
    x_tm = jnp.transpose(jnp.asarray(tx), (1, 0, 2))
    step = js_mod._jitted_step(rules)
    state = step(state, x_tm, jnp.asarray(ty))
    want = step(state, x_tm, jnp.asarray(ty))
    got = ts_mod.admm_s_step(
        ts_mod.admm_s_state_from_numpy(state),
        torch.from_numpy(np.ascontiguousarray(tx.transpose(1, 0, 2))),
        torch.from_numpy(ty), ts_mod.ADMMSRules())
    assert got.epoch == int(want.epoch) == 2
    z, gate, c, h, y = js_mod._forward(want, x_tm, rules.precision)
    primal = {'z': z[:, -1], 'gate': gate[:, -1], 'c': c[-1], 'h': h[-1],
              'y': y}
    errs = {}
    for f in ts_mod.ADMMSState._fields[:-1]:
        ref, out = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert out.shape == ref.shape, f
        scale = float(np.abs(ref).max())
        if f in DUAL_OF:
            name, rho = DUAL_OF[f]
            scale += getattr(rules, rho) * float(
                np.abs(np.asarray(primal[name])).max())
        errs[f] = (float(np.abs(out - ref).max()), STEP_RTOL * scale)
    bad = {f: e for f, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad


def test_torch_admm_s_predict_matches_jax():
    state, tx, _ = _init_state(5)
    want = np.asarray(js_mod.predict(state, tx))
    got = ts_mod.predict(ts_mod.admm_s_state_from_numpy(state), tx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_torch_admm_s_golden_googlestock():
    """tests/golden/admm_s_googlestock.npz (the reference's constants,
    which diverge here) at the JAX test's tolerance; eager, so it needs no
    compilation and runs in seconds."""
    g = np.load(os.path.join(GOLDEN, 'admm_s_googlestock.npz'))
    (tx, ty, vx, vy), _, _ = load_dataset('GoogleStock')
    res = ts_mod.admm_s_demo(len(g['train_loss']) - 1, 10, tx, ty, vx, vy,
                             seed=0, log_every=0, device='cpu')
    np.testing.assert_allclose(res['train_loss'], g['train_loss'],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(res['val_loss'], g['val_loss'],
                               rtol=2e-4, atol=1e-6)


def test_torch_admm_s_demo_matches_jax(tmp_path):
    """Three epochs on the synthetic problem, both packages; the
    results_path export reads back through load_admm_s_cache."""
    tx, ty, vx, vy = _data(4, batch=16)
    want = js_mod.admm_s_demo(3, 3, tx, ty, vx, vy, seed=0, log_every=0)
    path = str(tmp_path / 'results.py')
    got = ts_mod.admm_s_demo(3, 3, tx, ty, vx, vy, seed=0, log_every=0,
                             results_path=path, device='cpu')
    assert got['name'] == 'ADMM-LSTM-S'
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got['val_loss'], want['val_loss'],
                               rtol=TRAJ_RTOL)
    cached = load_admm_s_cache(path)
    assert cached['train_loss'] == got['train_loss']
    assert cached['val_loss'] == got['val_loss']


@pytest.mark.parametrize('seq_len', [2, 3])
def test_torch_admm_s_short_sequences_run(seq_len):
    tx, ty, vx, vy = synth(batch=8, seq_len=seq_len, input_size=1,
                           output_size=1, val_batch=4)
    res = ts_mod.admm_s_demo(2, 3, tx, ty, vx, vy, seed=0, log_every=0,
                             device='cpu')
    assert len(res['train_loss']) == 3
    assert all(np.isfinite(res['train_loss']))


def test_torch_admm_s_demo_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    tx, ty, vx, vy = _data(3)
    with pytest.raises(NoCudaDeviceError):
        ts_mod.admm_s_demo(1, 3, tx, ty, vx, vy)
