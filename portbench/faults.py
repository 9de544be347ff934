"""Faults planted in the program, to show that the comparison catches
them (tests/test_portbench_faults.py, and `calibrate.py` on the card):

  * unchanged: the epoch returns its state unchanged (the epoch count
    moves on);
  * half_batch: the epoch sees the first half of the batch twice, so
    every mean over the batch is the mean over that half;
  * altered: each epoch's validation loss is produced 1% high.

The fault of a missing exchange between chips has no place here: every
cell runs on one chip.  `planted(name, model)` patches, for its body,
the program's epoch step or loss function where the model's module
(models/) says they are (`fault_targets`); 'none' and 'control' plant
nothing.
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
def planted(name: str, model):
    if name in ('none', 'control'):
        yield
        return
    targets = model.fault_targets()
    if name == 'altered':
        pairs, make = targets['loss'], _altered
    elif name in ('unchanged', 'half_batch'):
        pairs = targets['step']
        make = _unchanged if name == 'unchanged' else _half_batch
    else:
        raise ValueError(f'unknown fault {name!r}')
    saved = [getattr(m, attr) for m, attr in pairs]
    try:
        for (m, attr), real in zip(pairs, saved):
            setattr(m, attr, make(real))
        yield
    finally:
        for (m, attr), real in zip(pairs, saved):
            setattr(m, attr, real)
