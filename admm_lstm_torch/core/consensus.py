"""The consensus reducer: sums over the batch made global across ranks.

Under data parallelism every rank holds a contiguous block of the batch
and the weights are replicated, so every sum over the batch axis that the
epoch computes (the weight gradients, the line searches' objectives, the
Gram systems, the residuals and the training loss) is a partial sum
until it is all-reduced.  Each solver takes a `Consensus` and passes its
batch sums through `all_sum` before it uses them; the default, `LOCAL`,
is the identity, so a single process computes exactly what it computed
before.  Every rank then sees the same global sums, takes the same
branches and makes the same host reads, and its replicated weights stay
bit-equal to every other rank's.

The JAX package gets this from GSPMD, which turns each batch reduction
into a psum (admm_lstm_tpu/parallel/sharding.py:1-17).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


class Consensus:
    """`all_sum(t)` is `dist.all_reduce(t, group=group)` on a contiguous
    copy of `t` where `t` is not contiguous (callers use the returned
    tensor), and the identity when the world is 1.  `calls` and `nbytes`
    count the all-reduces made and the bytes they carried, per rank."""

    def __init__(self, group=None, world: int = 1) -> None:
        self.group = group
        self.world = int(world)
        self.calls = 0
        self.nbytes = 0

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
            return t
        t = t.contiguous()
        self.calls += 1
        self.nbytes += t.numel() * t.element_size()
        dist.all_reduce(t, group=self.group)
        return t

    def all_sum_packed(self, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Several partial sums in one all-reduce; returns them in order
        and shape."""
        if self.world == 1:
            return ts
        flat = self.all_sum(torch.cat([t.reshape(-1) for t in ts]))
        return tuple(part.view(t.shape) for part, t in
                     zip(flat.split([t.numel() for t in ts]), ts))

    def mean(self, local_means: torch.Tensor) -> torch.Tensor:
        """The global mean from each rank's mean over its block.  The
        blocks are equal in size (train_sharded pads the batch to a
        multiple of the world), so the global mean is the mean of the
        ranks' means."""
        if self.world == 1:
            return local_means
        return self.all_sum(local_means) / self.world

    def means(self, local_means: Sequence[torch.Tensor]):
        """`mean` of several 0-d tensors in one all-reduce."""
        if self.world == 1:
            return tuple(local_means)
        return tuple(self.mean(torch.stack(list(local_means))).unbind())


LOCAL = Consensus()
