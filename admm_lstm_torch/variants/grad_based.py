"""Gradient-based full-batch baselines: SGD, Adam and Adagrad.

Counterpart of `admm_lstm_tpu/variants/grad_based.py` (reference:
comparison_experiment/grad_based/grad_based.py): the same bias-free
LSTM-Linear model, full-batch MSE training by backpropagation through
time (autograd through `models/lstm.mse_loss`, not cuDNN's LSTM, whose
gate layout and function differ), the same default learning rates
(demo.py:58-63: sgd 1.5, adam 0.2, adagrad 1.0) and optional
per-parameter gradient-norm recording (grad_based.py:13,34-37), used to
show gradient explosion.

The JAX package's optimizers are optax's.  SGD is `torch.optim.SGD`.
Adam and Adagrad are written out in optax's rule and order:
  * optax's adam takes its bias corrections 1 - b^t in float32, where
    `torch.optim.Adam` takes them in float64.  In float32, 1 - 0.999 is
    off by 1.3e-5 relative, so the first steps of the two differ by up to
    7e-6 relative, enough to move the losses by 3e-5 in 20 epochs at
    lr 0.2; `OptaxAdam` takes them in float32 as optax does;
  * optax's adagrad is not `torch.optim.Adagrad`: it starts its
    accumulator at 0.1 and scales by rsqrt(sum g^2 + 0.1 + 1e-7), where
    torch's divides by sqrt(sum g^2) + eps from 0 (`OptaxAdagrad`).
The losses and gradient norms stay on the device until the run ends or a
log line reads them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from admm_lstm_torch.models.lstm import LSTMParams, init_lstm_params, mse_loss
from admm_lstm_torch.utils.device import (as_tensor, matmul_precision,
                                          resolve_device)
from admm_lstm_torch.utils.logging import info

DEFAULT_LRS = {'sgd': 1.5, 'adam': 0.2, 'adagrad': 1.0}
EXPLOSION_DEMO_LR = 7.4  # grad_based.py:75-76
NAMES = {'sgd': 'SGD', 'adam': 'Adam', 'adagrad': 'Adagrad'}


class OptaxAdam(torch.optim.Optimizer):
    """optax.adam (0.2.6, eps_root 0): m <- (1 - b1) g + b1 m,
    v <- (1 - b2) g^2 + b2 v, p <- p - lr * (m / c1) / (sqrt(v / c2) + eps)
    with the bias corrections c = 1 - b^t in float32.  The step count is
    a host int, so a step never waits for the device."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(step=0, m=torch.zeros_like(p),
                                 v=torch.zeros_like(p))
                state['step'] += 1
                g, t = p.grad, state['step']
                state['m'] = (1 - b1) * g + b1 * state['m']
                state['v'] = (1 - b2) * (g * g) + b2 * state['v']
                c1 = float(1 - np.float32(b1) ** np.float32(t))
                c2 = float(1 - np.float32(b2) ** np.float32(t))
                u = (state['m'] / c1) / (torch.sqrt(state['v'] / c2)
                                         + group['eps'])
                p.add_(u * -group['lr'])
        return None


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad (0.2.6): s <- s + g^2 from s = initial_accumulator_value;
    p <- p - lr * g * rsqrt(s + eps) where s > 0 (else no step)."""

    def __init__(self, params, lr: float = 1.0,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['sum'] = torch.full_like(
                        p, group['initial_accumulator_value'])
                s = state['sum']
                s.add_(p.grad * p.grad)
                scale = torch.where(s > 0, torch.rsqrt(s + group['eps']),
                                    torch.zeros_like(s))
                p.add_(scale * p.grad * -group['lr'])
        return None


def _make_optimizer(method: str, params, lr: float) -> torch.optim.Optimizer:
    if method == 'sgd':
        return torch.optim.SGD(params, lr=lr)
    if method == 'adam':
        return OptaxAdam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if method == 'adagrad':
        return OptaxAdagrad(params, lr=lr)
    raise ValueError(f'unknown method {method!r}; use sgd/adam/adagrad')


def train_grad_based(method: str, train_x, train_y, val_x, val_y,
                     epochs: int, params: Optional[LSTMParams] = None,
                     hidden_size: int = 10, lr: Optional[float] = None,
                     seed: int = 0, record_gradients: bool = False,
                     log_every: int = 0, device='cuda') -> Dict[str, object]:
    """Full-batch gradient training on `device` ('cuda' by default; the
    CPU only when asked).  `params` (left untouched; the run trains a
    copy) defaults to `init_lstm_params` from
    `torch.Generator().manual_seed(seed)`; the JAX package draws from
    `jax.random`, so parity carries its weights across.

    Matmuls run at 'highest' (TF32 off).  Returns the comparison-harness
    dict {'name', 'train_loss', 'val_loss', 'gradients', 'params'};
    'gradients' holds the per-epoch norms of the wx, wh and wy gradients
    when `record_gradients`."""
    if method not in DEFAULT_LRS:
        raise ValueError(f'unknown method {method!r}; use sgd/adam/adagrad')
    device = resolve_device(device)
    with matmul_precision('highest'):
        return _train_grad_based(method, train_x, train_y, val_x, val_y,
                                 epochs, params, hidden_size, lr, seed,
                                 record_gradients, log_every, device)


def make_grad_epoch(method: str, params: LSTMParams, train_x, train_y,
                    val_x, val_y, lr: Optional[float] = None):
    """(model, epoch): `model` is a trainable copy of `params` and each
    `epoch()` takes one full-batch step of `method` on it and returns the
    (5,) device tensor [train loss, val loss, |grad wx|, |grad wh|,
    |grad wy|] (the losses after the step, the norms of the step's
    gradients).  Inputs are tensors on the model's device."""
    leaves = [w.detach().clone().requires_grad_(True) for w in params]
    model = LSTMParams(*leaves)
    opt = _make_optimizer(method, leaves,
                          DEFAULT_LRS[method] if lr is None else lr)

    def epoch():
        opt.zero_grad(set_to_none=True)
        mse_loss(model, train_x, train_y).backward()
        with torch.no_grad():
            gns = torch.stack([torch.sqrt(torch.sum(w.grad * w.grad))
                               for w in leaves])
            opt.step()
            return torch.cat([torch.stack([mse_loss(model, train_x, train_y),
                                           mse_loss(model, val_x, val_y)]),
                              gns])

    return model, epoch


def _train_grad_based(method, train_x, train_y, val_x, val_y, epochs, params,
                      hidden_size, lr, seed, record_gradients, log_every,
                      device):
    train_x, train_y = as_tensor(train_x, device), as_tensor(train_y, device)
    val_x, val_y = as_tensor(val_x, device), as_tensor(val_y, device)
    if params is None:
        params = init_lstm_params(torch.Generator().manual_seed(seed),
                                  train_x.shape[2], hidden_size,
                                  train_y.shape[1], device=device)
    model, epoch_fn = make_grad_epoch(method, params.to(device), train_x,
                                      train_y, val_x, val_y, lr)

    with torch.no_grad():
        train_loss: List[float] = [float(mse_loss(model, train_x, train_y))]
        val_loss: List[float] = [float(mse_loss(model, val_x, val_y))]
    metrics = []
    for epoch in range(1, epochs + 1):
        metrics.append(epoch_fn())
        if log_every and epoch % log_every == 0:
            tl, vl = metrics[-1][:2].tolist()
            info(f'{method.upper()}: Epoch {epoch}/{epochs}, '
                 f'Loss: {tl:.8f}, Val: {vl:.8f}')

    gradients: Dict[str, List[float]] = {}
    if metrics:
        hist = torch.stack(metrics).cpu()
        train_loss += hist[:, 0].tolist()
        val_loss += hist[:, 1].tolist()
        if record_gradients:
            gradients = {k: hist[:, 2 + j].tolist()
                         for j, k in enumerate(('wx', 'wh', 'wy'))}
    elif record_gradients:
        gradients = {'wx': [], 'wh': [], 'wy': []}

    return {
        'name': NAMES[method],
        'train_loss': train_loss,
        'val_loss': val_loss,
        'gradients': gradients,
        'params': LSTMParams(*(w.detach() for w in model)),
    }


def sgd_demo(num_epochs, train_x, train_y, test_x, test_y, lr=None, **kw):
    return train_grad_based('sgd', train_x, train_y, test_x, test_y,
                            num_epochs, lr=lr, **kw)


def adam_demo(num_epochs, train_x, train_y, test_x, test_y, lr=None, **kw):
    return train_grad_based('adam', train_x, train_y, test_x, test_y,
                            num_epochs, lr=lr, **kw)


def adagrad_demo(num_epochs, train_x, train_y, test_x, test_y, lr=None, **kw):
    return train_grad_based('adagrad', train_x, train_y, test_x, test_y,
                            num_epochs, lr=lr, **kw)
