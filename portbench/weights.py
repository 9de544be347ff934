"""Initial weights and seeds.

Every job of a run (a training run or a rho search) starts from weights
of its own, Xavier-normal as the port's and the reference's
`init_lstm_params` draw them (blocks/lstm.py:23-29), made on the device
by one `torch.Generator` seeded from the run's seed and the job's index,
in one call for all nine blocks.
"""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for stream `stream` (a job's index, or -1
    for the data) of the run seeded `seed`; any whole seed works."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + (int(stream) + 2)
             * 0xBF58476D1CE4E5B9) & _MASK
    mixed ^= mixed >> 31
    return (mixed * 0x94D049BB133111EB) & _MASK


def xavier_weights(seed: int, job: int, sizes: dict, device):
    """(wx (4, I, H), wh (4, H, H), wy (H, O)) of job `job`."""
    i, h, o = sizes['I'], sizes['H'], sizes['O']
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, job))
    shapes = [(i, h)] * 4 + [(h, h)] * 4 + [(h, o)]
    flat = torch.randn(sum(a * b for a, b in shapes), generator=gen,
                       device=device)
    blocks, at = [], 0
    for a, b in shapes:
        std = (2.0 / (a + b)) ** 0.5
        blocks.append(flat[at:at + a * b].reshape(a, b) * std)
        at += a * b
    return (torch.stack(blocks[:4]), torch.stack(blocks[4:8]),
            blocks[8].contiguous())
