"""Faults planted in the program, to show that the comparison catches
them (tests/test_portbench_faults.py, and `calibrate.py` on the card):

  * unchanged: the epoch returns its state unchanged (the epoch count
    moves on);
  * half_batch: the epoch sees the first half of the batch twice, so
    every mean over the batch is the mean over that half;
  * altered: each epoch's validation loss is produced 1% high.

The fault of a missing exchange between chips has no place here: every
cell runs on one chip.  `planted(name)` patches the port's modules for
its body; 'none' and 'control' plant nothing.
"""

from __future__ import annotations

import contextlib

FAULTS = ('unchanged', 'half_batch', 'altered')


def _unchanged(real):
    def step(state, x_im, y_im, rules):
        return state._replace(epoch=state.epoch + 1)
    return step


def _half_batch(real):
    import torch

    def step(state, x_im, y_im, rules):
        batch = x_im.shape[-1]
        idx = torch.arange(batch, device=x_im.device) % max(batch // 2, 1)
        return real(state, x_im[..., idx].contiguous(),
                    y_im[..., idx].contiguous(), rules)
    return step


def _altered(real):
    def losses(*args, **kw):
        train, val = real(*args, **kw)
        return train, val * 1.01
    return losses


@contextlib.contextmanager
def planted(name: str):
    if name in ('none', 'control'):
        yield
        return
    from admm_lstm_torch import tune
    from admm_lstm_torch.core import step
    if name == 'altered':
        targets, attr, make = (step, tune), 'train_val_mse_im', _altered
    elif name in ('unchanged', 'half_batch'):
        targets, attr = (step, tune), 'admm_step_im'
        make = _unchanged if name == 'unchanged' else _half_batch
    else:
        raise ValueError(f'unknown fault {name!r}')
    saved = [getattr(m, attr) for m in targets]
    try:
        for m, real in zip(targets, saved):
            setattr(m, attr, make(real))
        yield
    finally:
        for m, real in zip(targets, saved):
            setattr(m, attr, real)
