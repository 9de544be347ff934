"""The bias-free LSTM-Linear model as plain functions over a weight tuple.

Counterpart of `admm_lstm_tpu/models/lstm.py` (reference: blocks/lstm.py):
weights x2{i,f,g,o} (I, H), h2{i,f,g,o} (H, H) stacked as wx (4, I, H)
and wh (4, H, H), readout wy (H, O).  Forward histories are time-major
(T+1, B, H) with a zero row 0; the `_im` functions take batch-minor
(T, I, B) inputs as the training loop keeps them.

`init_lstm_params` draws Xavier-normal weights from a `torch.Generator`.
The JAX package draws from `jax.random`, which torch cannot reproduce, so
the two inits agree only in distribution: parity with the JAX package
always carries its weights across through `params_from_numpy` /
`params_from_dict`.

Matmul precision is the process-wide torch setting
(utils/device.set_matmul_precision); there is no per-call argument.

With the candidate axis (core/state.py) every weight has a leading S
axis; `lstm_forward_with_history` and the `_im` functions then run the S
models at once, on inputs shared by the candidates (no leading axis,
broadcast) or with one leading S axis of their own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from admm_lstm_torch.core.consensus import LOCAL, Consensus

# Gate order everywhere in this framework: i, f, g, o.
GATE_ORDER = ('i', 'f', 'g', 'o')


class LSTMParams(NamedTuple):
    """wx: (4, I, H); wh: (4, H, H); wy: (H, O) (each with a leading S
    axis under the candidate axis)."""

    wx: torch.Tensor
    wh: torch.Tensor
    wy: torch.Tensor

    @property
    def input_size(self) -> int:
        return self.wx.shape[-2]

    @property
    def hidden_size(self) -> int:
        return self.wh.shape[-1]

    @property
    def output_size(self) -> int:
        return self.wy.shape[-1]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self)

    def rebuild(self, tensors) -> 'LSTMParams':
        """The same structure over `tensors`, in `tensors()` order."""
        return LSTMParams(*tensors)

    def to(self, device) -> 'LSTMParams':
        return LSTMParams(*(w.to(device) for w in self))

    def clone(self) -> 'LSTMParams':
        return LSTMParams(*(w.clone() for w in self))


def _xavier_normal(gen: torch.Generator, shape: Tuple[int, int],
                   dtype, device) -> torch.Tensor:
    fan_in, fan_out = shape
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return (std * torch.randn(shape, generator=gen, dtype=dtype,
                              device=gen.device)).to(device)


def init_lstm_params(generator: torch.Generator, input_size: int,
                     hidden_size: int, output_size: int,
                     dtype=torch.float32, device='cpu') -> LSTMParams:
    """Xavier-normal init of all 9 weight blocks (blocks/lstm.py:23-29)."""
    wx = torch.stack([_xavier_normal(generator, (input_size, hidden_size),
                                     dtype, device) for _ in range(4)])
    wh = torch.stack([_xavier_normal(generator, (hidden_size, hidden_size),
                                     dtype, device) for _ in range(4)])
    wy = _xavier_normal(generator, (hidden_size, output_size), dtype, device)
    return LSTMParams(wx=wx, wh=wh, wy=wy)


def params_from_numpy(wx, wh, wy, device='cpu') -> LSTMParams:
    """Carry stacked weights, as numpy arrays (e.g. a JAX package's
    LSTMParams converted with np.asarray, or a vmapped batch of them with
    a leading S axis), into the port as f32 tensors."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return LSTMParams(wx=t(wx), wh=t(wh), wy=t(wy))


def params_from_dict(weights: dict, device='cpu') -> LSTMParams:
    """LSTMParams from {'x2i': ..., 'h2i': ..., ..., 'wy': ...} arrays
    (the reference's weight naming, blocks/lstm.py:24-27), each with an
    optional leading S axis."""
    wx = np.stack([np.asarray(weights[f'x2{g}']) for g in GATE_ORDER], -3)
    wh = np.stack([np.asarray(weights[f'h2{g}']) for g in GATE_ORDER], -3)
    wy = weights['wy'] if 'wy' in weights else weights['out']
    return params_from_numpy(wx, wh, wy, device=device)


def _gate_activations(pre: torch.Tensor):
    """pre: (..., 4, H) pre-activations in gate order -> (i, f, g, o)."""
    return (torch.sigmoid(pre[..., 0, :]), torch.sigmoid(pre[..., 1, :]),
            torch.tanh(pre[..., 2, :]), torch.sigmoid(pre[..., 3, :]))


def lstm_forward(params: LSTMParams, x: torch.Tensor,
                 c0: Optional[torch.Tensor] = None,
                 h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inference: (B, T, I) -> (B, O) prediction from the final hidden state."""
    batch = x.shape[0]
    hdim = params.hidden_size
    h = x.new_zeros((batch, hdim)) if h0 is None else h0
    c = x.new_zeros((batch, hdim)) if c0 is None else c0
    xproj = torch.einsum('bti,gih->tbgh', x, params.wx)
    for xp_t in xproj:
        pre = xp_t + torch.einsum('bh,ghk->bgk', h, params.wh)
        i, f, g, o = _gate_activations(pre)
        c = f * c + i * g
        h = o * torch.tanh(c)
    return h @ params.wy


def lstm_forward_with_history(params: LSTMParams, x: torch.Tensor) -> dict:
    """Full unroll returning all gate trajectories (blocks/lstm.py:65-88).

    Returns dict with keys 'i','f','g','o','c','h' of shape (T+1, B, H)
    (row 0 = zero initial state) and 'a' of shape (B, O); with the
    candidate axis (S, T+1, B, H) and (S, B, O).
    """
    lead = torch.broadcast_shapes(x.shape[:-3], params.wx.shape[:-3])
    zeros = x.new_zeros(lead + (x.shape[-3], params.hidden_size))
    xproj = torch.einsum('...bti,...gih->...tbgh', x, params.wx)
    h, c = zeros, zeros
    hist = {k: [zeros] for k in ('i', 'f', 'g', 'o', 'c', 'h')}
    for xp_t in xproj.unbind(-4):
        pre = xp_t + torch.einsum('...bh,...ghk->...bgk', h, params.wh)
        i, f, g, o = _gate_activations(pre)
        c = f * c + i * g
        h = o * torch.tanh(c)
        for k, v in zip(('i', 'f', 'g', 'o', 'c', 'h'), (i, f, g, o, c, h)):
            hist[k].append(v)
    out = {k: torch.stack(v, dim=-3) for k, v in hist.items()}
    out['a'] = h @ params.wy
    return out


def mse_loss(params: LSTMParams, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    pred = lstm_forward(params, x)
    return torch.mean((pred - y) ** 2)


def final_h_im(params: LSTMParams, x_im: torch.Tensor) -> torch.Tensor:
    """(T, I, B) inputs -> final hidden state (H, B), batch-minor ((S, H,
    B) with the candidate axis)."""
    lead = torch.broadcast_shapes(x_im.shape[:-3], params.wx.shape[:-3])
    h = x_im.new_zeros(lead + (params.hidden_size, x_im.shape[-1]))
    c = torch.zeros_like(h)
    xproj = torch.einsum('...tdb,...gdh->...tghb', x_im, params.wx)
    for xp_t in xproj.unbind(-4):
        pre = xp_t + torch.einsum('...hb,...ghk->...gkb', h, params.wh)
        i = torch.sigmoid(pre[..., 0, :, :])
        f = torch.sigmoid(pre[..., 1, :, :])
        g = torch.tanh(pre[..., 2, :, :])
        o = torch.sigmoid(pre[..., 3, :, :])
        c = f * c + i * g
        h = o * torch.tanh(c)
    return h


def train_val_mse_im(params: LSTMParams, xall_im: torch.Tensor,
                     y_im: torch.Tensor, vy_im: torch.Tensor,
                     consensus: Consensus = LOCAL):
    """Both epoch metrics from ONE forward over the train and validation
    inputs concatenated along the batch axis, (T, I, B + Bv).  Returns
    0-d tensors on the inputs' device (no host sync).

    Under data parallelism the train inputs are this rank's block of the
    batch and the train loss is the global mean over `consensus`; the
    validation inputs are whole on every rank (as the JAX package
    replicates them), so the validation loss needs no reduction.

    With the candidate axis both losses are (S,), each candidate's mean
    over its own (O, B) predictions (only in one process)."""
    nb = y_im.shape[-1]
    h = final_h_im(params, xall_im)
    pred = torch.einsum('...hb,...ho->...ob', h, params.wy)
    if h.dim() == 3:
        return (torch.mean((pred[..., :nb] - y_im) ** 2, dim=(-2, -1)),
                torch.mean((pred[..., nb:] - vy_im) ** 2, dim=(-2, -1)))
    train = consensus.mean(torch.mean((pred[:, :nb] - y_im) ** 2))
    val = torch.mean((pred[:, nb:] - vy_im) ** 2)
    return train, val

