"""The port's LSTM model functions against the JAX package's, from the
same numpy weights carried across with `params_from_numpy`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_lstm_tpu.models import lstm as jl
from admm_lstm_torch.models import lstm as tl

torch.set_num_threads(1)

ATOL = 1e-5


def _case(seed=0, batch=23, seq_len=7, inp=3, hidden=5, out=2):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    wx = f32(rng.standard_normal((4, inp, hidden)) * 0.5)
    wh = f32(rng.standard_normal((4, hidden, hidden)) * 0.4)
    wy = f32(rng.standard_normal((hidden, out)) * 0.5)
    x = f32(rng.standard_normal((batch, seq_len, inp)))
    y = f32(rng.standard_normal((batch, out)))
    return (wx, wh, wy), x, y


def test_torch_forward_with_history_matches_jax():
    w, x, _ = _case()
    ref = jl.lstm_forward_with_history(jl.LSTMParams(*map(jnp.asarray, w)),
                                       jnp.asarray(x))
    got = tl.lstm_forward_with_history(tl.params_from_numpy(*w),
                                       torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


def test_torch_mse_loss_matches_jax():
    w, x, y = _case(seed=1)
    ref = jl.mse_loss(jl.LSTMParams(*map(jnp.asarray, w)), jnp.asarray(x),
                      jnp.asarray(y))
    got = tl.mse_loss(tl.params_from_numpy(*w), torch.from_numpy(x),
                      torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(ref), atol=ATOL)


def test_torch_train_val_mse_im_matches_jax():
    w, x, y = _case(seed=2)
    _, vx, vy = _case(seed=3, batch=9)
    to_im = lambda a: np.ascontiguousarray(np.transpose(a, (1, 2, 0)))
    xall = np.concatenate([to_im(x), to_im(vx)], axis=-1)
    ref = jl.train_val_mse_im(jl.LSTMParams(*map(jnp.asarray, w)),
                              jnp.asarray(xall), jnp.asarray(y.T),
                              jnp.asarray(vy.T))
    got = tl.train_val_mse_im(tl.params_from_numpy(*w), torch.from_numpy(xall),
                              torch.from_numpy(np.ascontiguousarray(y.T)),
                              torch.from_numpy(np.ascontiguousarray(vy.T)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), atol=ATOL)
    # And the per-split forwards agree with it.
    p = tl.params_from_numpy(*w)
    np.testing.assert_allclose(float(got[1]),
                               float(tl.mse_loss(p, torch.from_numpy(vx),
                                                 torch.from_numpy(vy))),
                               atol=ATOL)


def test_torch_params_from_dict_matches_jax():
    w, _, _ = _case(seed=4)
    d = {f'x2{g}': w[0][k] for k, g in enumerate('ifgo')}
    d.update({f'h2{g}': w[1][k] for k, g in enumerate('ifgo')}, out=w[2])
    ref = jl.params_from_dict(d)
    got = tl.params_from_dict(d)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize('shape', [(1, 10, 1), (9, 64, 3)])
def test_torch_init_is_xavier_normal(shape):
    """The port's init matches the Xavier-normal statistics (not the JAX
    random stream, which torch cannot reproduce) and is seeded."""
    inp, hidden, out = shape
    gen = torch.Generator().manual_seed(0)
    p = tl.init_lstm_params(gen, inp, hidden, out)
    assert p.wx.shape == (4, inp, hidden) and p.wh.shape == (4, hidden, hidden)
    assert p.wy.shape == (hidden, out)
    std = np.std(p.wh.numpy())
    assert abs(std - np.sqrt(2.0 / (2 * hidden))) < 0.25 * np.sqrt(1.0 / hidden)
    again = tl.init_lstm_params(torch.Generator().manual_seed(0), inp,
                                hidden, out)
    for a, b in zip(p, again):
        assert torch.equal(a, b)
