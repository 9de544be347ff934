"""The port's gradient baselines (admm_lstm_torch/variants/grad_based.py)
against the JAX package's optax runs, on the CPU: SGD, Adam and Adagrad,
20 full-batch epochs from the JAX package's PRNGKey(0) weights on its
seeded synthetic problem (B 64, T 6, I 2, H 5)."""

import os

import jax
import numpy as np
import pytest
import torch

from admm_lstm_tpu.data.synthetic import load as synth
from admm_lstm_tpu.models.lstm import init_lstm_params
from admm_lstm_tpu.variants import grad_based as jg
from admm_lstm_torch.models.lstm import params_from_numpy
from admm_lstm_torch.utils.device import NoCudaDeviceError
from admm_lstm_torch.variants import grad_based as tg

torch.set_num_threads(1)
os.environ.setdefault('ADMM_TORCH_NO_FILELOG', '1')

# f32: autograd and XLA's gradient sum in other orders; 20 epochs at the
# default learning rates move the losses and gradient norms by ~1e-6.
RTOL = 1e-5
EPOCHS = 20


@pytest.fixture(scope='module')
def problem():
    data = synth(batch=64, seq_len=6, input_size=2, output_size=1,
                 val_batch=16)
    return data, init_lstm_params(jax.random.PRNGKey(0), 2, 5, 1)


def _port_params(jp):
    return params_from_numpy(*(np.array(w) for w in jp))


@pytest.mark.parametrize('method', ['sgd', 'adam', 'adagrad'])
def test_torch_grad_based_matches_optax(problem, method):
    (tx, ty, vx, vy), jp = problem
    want = jg.train_grad_based(method, tx, ty, vx, vy, EPOCHS, params=jp,
                               record_gradients=True)
    params = _port_params(jp)
    got = tg.train_grad_based(method, tx, ty, vx, vy, EPOCHS, params=params,
                              record_gradients=True, device='cpu')
    assert got['name'] == want['name']
    assert len(got['train_loss']) == EPOCHS + 1
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               rtol=RTOL)
    np.testing.assert_allclose(got['val_loss'], want['val_loss'], rtol=RTOL)
    for k in ('wx', 'wh', 'wy'):
        np.testing.assert_allclose(got['gradients'][k], want['gradients'][k],
                                   rtol=RTOL, err_msg=k)
    for w, g in zip(want['params'], got['params']):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    # The run trains a copy: the caller's weights are untouched.
    for w, p in zip(jp, params):
        assert np.array_equal(p.numpy(), np.asarray(w))


@pytest.mark.parametrize('method,lr', [('sgd', 0.3), ('adam', 0.05),
                                       ('adagrad', 0.3)])
def test_torch_grad_based_explicit_lr(problem, method, lr):
    """A learning rate other than the default, through the *_demo
    wrappers; no gradients recorded unless asked."""
    (tx, ty, vx, vy), jp = problem
    want = jg.train_grad_based(method, tx, ty, vx, vy, 5, params=jp, lr=lr)
    demo = {'sgd': tg.sgd_demo, 'adam': tg.adam_demo,
            'adagrad': tg.adagrad_demo}[method]
    got = demo(5, tx, ty, vx, vy, lr=lr, params=_port_params(jp),
               device='cpu')
    np.testing.assert_allclose(got['train_loss'], want['train_loss'],
                               rtol=RTOL)
    assert got['gradients'] == want['gradients'] == {}


def test_torch_optax_adagrad_first_steps():
    """optax's adagrad rule on one tensor: the accumulator starts at 0.1
    and the step is lr * g * rsqrt(sum g^2 + 0.1 + 1e-7)."""
    p = torch.tensor([1.0, -2.0, 0.5], requires_grad=True)
    opt = tg.OptaxAdagrad([p], lr=0.5)
    want = p.detach().double().clone()
    acc = torch.full((3,), 0.1, dtype=torch.float64)
    for g in ([0.3, -1.0, 0.0], [0.1, 2.0, -0.4]):
        g = torch.tensor(g)
        p.grad = g.clone()
        opt.step()
        acc += g.double() ** 2
        want -= 0.5 * g.double() / torch.sqrt(acc + 1e-7)
        np.testing.assert_allclose(p.detach().numpy(), want.numpy(),
                                   rtol=1e-6)


def test_torch_grad_based_rejects_unknown_method(problem):
    (tx, ty, vx, vy), _ = problem
    with pytest.raises(ValueError, match='rmsprop'):
        tg.train_grad_based('rmsprop', tx, ty, vx, vy, 1, device='cpu')


def test_torch_grad_based_needs_the_card_unless_asked(problem):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    (tx, ty, vx, vy), _ = problem
    with pytest.raises(NoCudaDeviceError):
        tg.train_grad_based('sgd', tx, ty, vx, vy, 1)
