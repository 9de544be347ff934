"""The port's ADMM-LSTM-L (admm_lstm_torch/variants/admm_l.py) against the
JAX package's, on the CPU.  Inputs are the JAX package's seeded synthetic
problem (B 24, T 6, I 2, H 4, and T 2); states carried across are a JAX
ADMMLState after one JAX epoch, converted with `admm_l_state_from_numpy`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.variants import admm_l as jl
from admm_lstm_torch.solvers.prox_linear import BLOCK_K, doubling_search
from admm_lstm_torch.utils.device import NoCudaDeviceError
from admm_lstm_torch.variants import admm_l as tl

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
# f32: the same math in another summation order.  One epoch: each leaf
# within STEP_RTOL of its scale (max |x|; for a dual, max |lambda| + rho
# max |its primal|: lambda + rho (primal - target) sums terms of the
# primal's size that nearly cancel).  Trajectories: TRAJ_RTOL.
STEP_RTOL = 1e-5
TRAJ_RTOL = 1e-5
DUAL_OF = {'lam_z': ('z', 'rho_singular'), 'lam_g': ('gate', 'rho_plural'),
           'lam9': ('c', 'rho9'), 'lam10': ('h', 'rho10'),
           'lam11': ('a', 'rho11')}


def _data(seq_len=6, batch=24, input_size=2):
    return synth(batch=batch, seq_len=seq_len, input_size=input_size,
                 output_size=1, val_batch=8)


def _states(seq_len, rules, hidden=4, x_scale=1.0, z_noise=0.0):
    """A JAX state after one JAX epoch (duals nonzero), z_noise times a
    seeded normal added to its z slab, the same state in the port, and the
    inputs (JAX x_tm, y; port x_tm, y)."""
    tx, ty, _, _ = _data(seq_len)
    tx = tx * np.float32(x_scale)
    x_tm = jnp.transpose(jnp.asarray(tx), (1, 0, 2))
    wx, wh, wy = jl.init_weights_like_reference(0, tx.shape[2], hidden, 1)
    js = jl.init_admm_l_state(wx, wh, wy, x_tm, rules)
    js = jl._jitted_step(rules)(js, x_tm, jnp.asarray(ty))
    if z_noise:
        noise = np.random.default_rng(1).standard_normal(js.z.shape)
        js = js._replace(z=js.z + jnp.asarray(z_noise * noise, jnp.float32))
    ts = tl.admm_l_state_from_numpy(js)
    return (js, ts, (x_tm, jnp.asarray(ty)),
            (torch.from_numpy(np.ascontiguousarray(tx.transpose(1, 0, 2))),
             torch.from_numpy(ty)))


def assert_state_close(js, ts, rules, rtol=STEP_RTOL):
    errs = {}
    for f in tl.ADMMLState._fields:
        if f == 'epoch':
            assert ts.epoch == int(js.epoch)
            continue
        ref, got = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert got.shape == ref.shape, f
        scale = float(np.abs(ref).max())
        if f in DUAL_OF:
            primal, rho = DUAL_OF[f]
            scale += getattr(rules, rho) * float(
                np.abs(np.asarray(getattr(js, primal))).max())
        errs[f] = (float(np.abs(got - ref).max()), rtol * scale)
    bad = {f: e for f, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad


@pytest.mark.parametrize('seed,shape', [(0, (2, 4, 1)), (3, (5, 10, 2))])
def test_torch_admm_l_init_bit_equal(seed, shape):
    """Both packages draw the reference's torch.randn(...) * 0.1 stream;
    the product rounds the same (0 ulp)."""
    want = jl.init_weights_like_reference(seed, *shape)
    got = tl.init_weights_like_reference(seed, *shape)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize('seq_len', [6, 2])
def test_torch_admm_l_step_matches_jax(seq_len):
    rules = jl.ADMMLRules()
    js, ts, (jx, jy), (tx, ty) = _states(seq_len, rules)
    js1 = jl._jitted_step(rules)(js, jx, jy)
    ts1 = tl.admm_l_step(ts, tx, ty, tl.ADMMLRules())
    assert_state_close(js1, ts1, rules)


def _k_of(theta, theta0):
    return int(np.round(np.log2(np.asarray(theta, np.float64) / theta0)))


# (rules, x_scale, expected doublings): the first at which the search
# accepts, more than one block of BLOCK_K, and the cap (no acceptance
# within max_backtrack, crossing a block boundary).
WY_CASES = {
    'short': (dict(), None),
    'blocks': (dict(wy_theta0=1e-10), lambda k: k > BLOCK_K),
    'cap': (dict(wy_theta0=1e-12, max_backtrack=BLOCK_K + 3),
            lambda k: k == BLOCK_K + 3),
}


@pytest.mark.parametrize('case', list(WY_CASES))
def test_torch_admm_l_wy_search_theta(case):
    kw, check = WY_CASES[case]
    rules = jl.ADMMLRules(**kw)
    js, ts, _, _ = _states(6, rules)
    want = np.asarray(jl._update_wy(js, rules), np.float64)
    got, theta = tl._update_wy(ts, tl.ADMMLRules(**kw))
    # JAX's theta from its result: wy_new - wy = grad / theta.
    h_last = np.asarray(js.h[-1], np.float64)
    resid = (np.asarray(js.a, np.float64) - h_last @ np.asarray(js.wy)
             + np.asarray(js.lam11) / rules.rho11)
    grad = rules.rho11 * h_last.T @ resid
    diff = want - np.asarray(js.wy, np.float64)
    k_jax = _k_of(np.sum(grad * grad) / np.sum(grad * diff), rules.wy_theta0)
    k = _k_of(float(theta), rules.wy_theta0)
    assert k == k_jax
    assert float(theta) == float(np.float32(rules.wy_theta0) * 2.0 ** k)
    if check is not None:
        assert check(k), k
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


STAGE_CASES = {
    'short': (dict(), 1.0, None),
    'blocks': (dict(), 12.0, lambda k: k.max() > BLOCK_K),
    'cap': (dict(max_backtrack=BLOCK_K + 2), 12.0,
            lambda k: k.max() == BLOCK_K + 2),
}


@pytest.mark.parametrize('case', list(STAGE_CASES))
def test_torch_admm_l_weight_stage_theta(case):
    """The four gates' lockstep W search (the input side, as
    admm_l_step's first stage runs it) on a state whose z is moved off
    the projections, so every gate's weights move: every gate's theta is
    JAX's."""
    kw, x_scale, check = STAGE_CASES[case]
    rules = jl.ADMMLRules(**kw)
    js, ts, (jx, _), (tx, _) = _states(6, rules, x_scale=x_scale,
                                       z_noise=0.1)
    h_hist = js.h[:-1]
    fixed = jnp.einsum('tbd,gdh->gtbh', h_hist, js.wh,
                       precision=jax.lax.Precision.HIGHEST)
    ridge = jnp.full((4,), rules.ridge_w, jnp.float32)
    want = np.asarray(jl._weight_stage(jx, fixed, js.wx, js.z, js.lam_z,
                                       ridge, rules, grad_side_inputs=jx),
                      np.float64)
    got, theta = tl._weight_stage(
        tx, torch.from_numpy(np.array(fixed)), ts.wx, ts.z, ts.lam_z,
        torch.full((4,), rules.ridge_w), tl.ADMMLRules(**kw),
        grad_side_inputs=tx)
    # JAX's theta per gate from (theta W - grad) / (ridge + theta).
    x64 = np.asarray(jx, np.float64)
    w0 = np.asarray(js.wx, np.float64)
    resid = (-np.asarray(js.z, np.float64)
             + np.einsum('tbd,gdh->gtbh', x64, w0) + np.asarray(fixed)
             - np.asarray(js.lam_z) / rules.rho_singular)
    grad = rules.rho_singular * np.einsum('tbd,gtbh->gdh', x64, resid)
    step = want - w0
    theta_jax = (-np.sum((grad + rules.ridge_w * want) * step, axis=(1, 2))
                 / np.sum(step * step, axis=(1, 2)))
    k_jax = np.round(np.log2(theta_jax)).astype(int)
    k = np.round(np.log2(theta.numpy())).astype(int)
    np.testing.assert_array_equal(k, k_jax)
    np.testing.assert_array_equal(theta.numpy(), 2.0 ** k)
    if check is not None:
        assert check(k), k
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


H_CASES = {
    'short': (dict(), None),
    'blocks': (dict(rho11=1e4), lambda k: k > BLOCK_K),
    'cap': (dict(rho11=1e4, max_backtrack=BLOCK_K + 1),
            lambda k: k == BLOCK_K + 1),
}


@pytest.mark.parametrize('case', list(H_CASES))
def test_torch_admm_l_final_h_search_theta(case):
    """The final-h search inside one JAX epoch: its theta, recovered from
    JAX's h_T, equals the port's search on the same inputs, and the whole
    epoch agrees."""
    kw, check = H_CASES[case]
    rules = jl.ADMMLRules(**kw)
    js, ts, (jx, jy), (tx, ty) = _states(6, rules)
    js1 = jl._jitted_step(rules)(js, jx, jy)
    f64 = lambda a: np.asarray(a, np.float64)
    t_last = jx.shape[0] - 1
    h_old, h_T = f64(js.h[t_last + 1]), f64(js1.h[t_last + 1])
    c_T, o_T = f64(js1.c[t_last + 1]), f64(js1.gate[2, t_last])
    wy = f64(js1.wy)
    r10, r11 = rules.rho10, rules.rho11
    form1 = r10 * (np.tanh(c_T) * o_T + f64(js.lam10[t_last]) / r10)
    form10 = -f64(js.a) + h_old @ wy - f64(js.lam11) / r11
    form11 = form10 @ wy.T
    step = h_T - h_old
    theta_jax = (np.sum((form1 - r11 * form11 - r10 * h_T) * step)
                 / np.sum(step * step))
    _, theta = tl._h_final_search(
        ts.h[t_last + 1], torch.from_numpy(np.array(js1.c[t_last + 1])),
        torch.from_numpy(np.array(js1.gate[2, t_last])), ts.lam10[t_last],
        ts, torch.from_numpy(np.array(js1.wy)), tl.ADMMLRules(**kw))
    k = _k_of(float(theta), 1.0)
    assert k == _k_of(theta_jax, 1.0)
    if check is not None:
        assert check(k), k
    assert_state_close(js1, tl.admm_l_step(ts, tx, ty, tl.ADMMLRules(**kw)),
                       rules)


@pytest.mark.parametrize('thresholds,max_iters', [
    ([3.0], 60), ([0.5, 1e3, 7e5, 1.0], 60), ([5e4], 10), ([5e4, 2.0], 16),
    ([1.0], 0)])
def test_torch_doubling_search_matches_the_sequential_loop(thresholds,
                                                           max_iters):
    """theta accepted once it reaches a threshold: the blocked search
    returns what `while fails and k < max_iters: theta *= 2` returns."""
    lim = torch.tensor(thresholds)
    theta0 = torch.full_like(lim, 0.25)
    want = []
    for t0, L in zip(theta0.tolist(), thresholds):
        theta, k = t0, 0
        while theta < L and k < max_iters:
            theta, k = theta * 2.0, k + 1
        want.append(theta)
    got, _ = doubling_search(lambda c: c < lim, theta0, max_iters)
    assert got.tolist() == want


def test_torch_admm_l_demo_golden():
    """tests/golden/admm_l_small.npz with the reference's 4224 divisor,
    at the JAX test's tolerance (tests/test_variants.py)."""
    g = np.load(os.path.join(GOLDEN, 'admm_l_small.npz'))
    res = tl.admm_l_demo(len(g['train_loss']) - 1, 4, g['x'], g['y'],
                         g['test_x'], g['test_y'], seed=0,
                         rules=tl.ADMMLRules(a_batch_scale=4224),
                         log_every=0, device='cpu')
    np.testing.assert_allclose(res['train_loss'], g['train_loss'],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(res['val_loss'], g['val_loss'],
                               rtol=1e-4, atol=1e-7)


def test_torch_admm_l_demo_matches_jax():
    """Five epochs with the true batch divisor, both packages."""
    tx, ty, vx, vy = _data()
    want = jl.admm_l_demo(5, 4, tx, ty, vx, vy, seed=0, log_every=0)
    got = tl.admm_l_demo(5, 4, tx, ty, vx, vy, seed=0, log_every=0,
                         device='cpu')
    assert got['name'] == 'ADMM-LSTM-L'
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got['val_loss'], want['val_loss'],
                               rtol=TRAJ_RTOL)
    for w, g in zip(want['params'], got['params']):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())


def test_torch_admm_l_demo_save(tmp_path, monkeypatch):
    """save=True writes the core-order model through ckpt.save_model."""
    from admm_lstm_torch.ckpt import load_model
    monkeypatch.chdir(tmp_path)
    tx, ty, vx, vy = _data()
    res = tl.admm_l_demo(1, 4, tx, ty, vx, vy, save=True, log_every=0,
                         device='cpu')
    loaded = load_model(str(tmp_path / 'SAVED_MODELS' / 'ADMM-LSTM-L.npz'),
                        device='cpu')
    for a, b in zip(loaded, res['params']):
        assert torch.equal(a, b)


def test_torch_admm_l_demo_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    tx, ty, vx, vy = _data()
    with pytest.raises(NoCudaDeviceError):
        tl.admm_l_demo(1, 4, tx, ty, vx, vy)
