"""The stacked N-layer ADMM-LSTM: the port's `variants/stacked.py`, through
`train_stacked` and `tune.search_rho_stacked`, against the plain
reference's `train_run` and `rho_search` (reference/admm_stacked.py),
from the same weights and data.

`sizes` gives the width H of every layer and their number `layers`.  The
penalties carry rho_z as the key 'z' (the grid's last column), which the
search gives the program per candidate.  The configuration's `solver`
block gives the program's ADMMConfig (`preset` 'default' and the fields
it sets), `control` the fields that switch on its lower-precision path,
and `reference_rules` the reference's Rules.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import weights as draws
from portbench.reference import admm_stacked as ref
from portbench.reference.admm_lstm import Rules

RHO_KEYS = ref.RHO_KEYS


def _hiddens(sizes: dict):
    return (sizes['H'],) * sizes['layers']


def weights(seed: int, job: int, sizes: dict, device):
    """(wx_0 (4, I, H), wh_0 (4, H, H), wy_0 (H, O), wx_1 (4, H, H), ...,
    the head wy (H, O)) of job `job`: every layer's blocks as the port's
    `init_stacked` draws them (each layer's own wy, which the stack does
    not use, included), Xavier-normal, then the head's."""
    i, o = sizes['I'], sizes['O']
    shapes, prev = [], i
    for h in _hiddens(sizes):
        shapes += [(prev, h)] * 4 + [(h, h)] * 4 + [(h, o)]
        prev = h
    blocks = draws.xavier_blocks(seed, job, shapes + [(prev, o)], device)
    out = []
    for k in range(len(_hiddens(sizes))):
        b = blocks[9 * k:9 * k + 9]
        out += [torch.stack(b[:4]), torch.stack(b[4:8]), b[8].contiguous()]
    return tuple(out) + (blocks[-1].contiguous(),)


def admm_config(config: dict, sizes: dict, epochs: int, control: bool):
    from admm_lstm_torch.utils.config import ADMMConfig
    solver = dict(config['solver'])
    if control:
        solver.update(config['control'])
    if solver.pop('preset') != 'default':
        raise ValueError('the stacked variant trains the default preset')
    return ADMMConfig(hidden_size=sizes['H'], epochs=epochs, **solver)


def _parameter_set(config: dict) -> dict:
    return {'rho': dict(config['rho']), 'beta': dict(config['beta'])}


def _params(w):
    from admm_lstm_torch.models.lstm import LSTMParams
    from admm_lstm_torch.variants.stacked import StackedParams
    n = (len(w) - 1) // 3
    return StackedParams(layers=tuple(LSTMParams(*w[3 * k:3 * k + 3])
                                      for k in range(n)), wy=w[-1])


def train(config, sizes, data, weights, epochs, device, control=False):
    from admm_lstm_torch.variants.stacked import train_stacked
    res = train_stacked(*data, _parameter_set(config),
                        admm_config(config, sizes, epochs, control),
                        log_every=0, hiddens=_hiddens(sizes),
                        track_best=False, params=_params(weights),
                        device=device)
    return {'train': np.asarray(res['train_loss'], np.float64),
            'val': np.asarray(res['val_loss'], np.float64),
            'weights': tuple(res['params'].tensors())}


def search(config, sizes, data, weights, candidates, epochs, device,
           control=False):
    from admm_lstm_torch import tune
    z = RHO_KEYS.index('z')
    res = tune.search_rho_stacked(
        *data, _parameter_set(config), _hiddens(sizes),
        config=admm_config(config, sizes, epochs, control),
        candidates=np.delete(candidates, z, axis=1), epochs=epochs,
        z_candidates=candidates[:, z], params=_params(weights),
        device=device)
    return {'train': np.asarray(res['train_losses'], np.float64),
            'val': np.asarray(res['val_losses'], np.float64),
            'order': np.asarray(res['order'])}


def _reference_layout(data):
    """x (T, I, B), y (O, B), x_all (T, I, B + Bv), vy (O, Bv)."""
    tx, ty, vx, vy = data
    x = tx.permute(1, 2, 0).contiguous()
    x_all = torch.cat([x, vx.permute(1, 2, 0)], dim=-1).contiguous()
    return x, ty.T.contiguous(), x_all, vy.T.contiguous()


def reference_train(config, data, weights, epochs):
    x, y, x_all, v = _reference_layout(data)
    rho = [config['rho'][k] for k in RHO_KEYS]
    train, val, final = ref.train_run(weights, x, y, x_all, v, rho,
                                      config['beta'], epochs,
                                      Rules(**config['reference_rules']))
    return {'train': train.astype(np.float64),
            'val': val.astype(np.float64), 'weights': final,
            'initial': weights}


def reference_search(config, data, weights, candidates, epochs):
    x, y, x_all, v = _reference_layout(data)
    train, val = ref.rho_search(weights, x, y, x_all, v, candidates,
                                config['beta'], epochs,
                                Rules(**config['reference_rules']))
    return {'train': train.astype(np.float64),
            'val': val.astype(np.float64)}


def epoch_ops(sizes: dict, reference_rules: dict) -> float:
    """The multiply-adds (2 operations each) of one stacked epoch of one
    instance, as the formulation states them; elementwise work is not
    counted.  N = T B rows, K_k = 4 H_k gate columns, D_0 = I.

      * layer 0, each side of width D (D = I, then H_0): its full Gram
        stack 2 K D^2 N, first-order term 2 K D N, G w 2 K D^2 and K
        Cholesky solves D^3/3 + 2 D^2; the projections x wx, h wh and the
        fresh x wx, 2 N K (2 I + H_0);
      * an upper layer k, X of D = H_{k-1} + H_k rows: the Gram X X^T
        2 D^2 N, the right-hand side 2 K D N, four solves of H_k columns
        4 (D^3/3 + 2 D^2 H_k);
      * the sweep: layer 0's x wx and h wh, 2 N K_0 (I + H_0); an upper
        layer's z input 2 N K_k (H_{k-1} + H_k); a lower layer's coupled
        h solve: wh h above, wx^T times the target, M^-1 times the
        right-hand side, 2 N (2 K_{k+1} H_k + H_k^2), and its matrix
        2 K_{k+1} H_k^2;
      * the head: the readout's two products and the final h's four,
        12 H O B;
      * the losses' forward over (B + Bv) T rows and the head.
    `reference_rules` does not change the count: layer 0 is always exact.
    """
    del reference_rules
    b, bv, t = sizes['B'], sizes['val'], sizes['T']
    i, o = sizes['I'], sizes['O']
    hs = _hiddens(sizes)
    n = t * b
    ops = 0.0
    k0 = 4 * hs[0]
    for d in (i, hs[0]):
        ops += (2 * k0 * d * d * n + 2 * k0 * d * n + 2 * k0 * d * d
                + k0 * (d ** 3 / 3 + 2 * d * d))
    ops += 2 * n * k0 * (2 * i + hs[0])
    for k in range(1, len(hs)):
        d, kk = hs[k - 1] + hs[k], 4 * hs[k]
        ops += 2 * d * d * n + 2 * kk * d * n + 4 * (d ** 3 / 3
                                                     + 2 * d * d * hs[k])
    ops += 2 * n * k0 * (i + hs[0])
    for k in range(1, len(hs)):
        ops += 2 * n * 4 * hs[k] * (hs[k - 1] + hs[k])
    for k in range(len(hs) - 1):
        above = 4 * hs[k + 1]
        ops += 2 * n * (2 * above * hs[k] + hs[k] ** 2)
        ops += 2 * above * hs[k] ** 2
    ops += 12 * hs[-1] * o * b
    rows = (b + bv) * t
    prev = i
    for h in hs:
        ops += 2 * rows * (prev + h) * 4 * h
        prev = h
    ops += 2 * hs[-1] * o * (b + bv)
    return float(ops)


def fault_targets():
    from admm_lstm_torch.variants import stacked
    return {'step': ((stacked, 'stacked_admm_step_im'),),
            'loss': ((stacked, 'stacked_train_val_mse_im'),)}
