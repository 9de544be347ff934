"""The collectives of a sharded epoch: one reducer per mesh axis.

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

A mesh has one `Consensus` per axis (parallel/mesh.py):

  * the 'data' axis holds blocks of the rows (t, b) of every slab: blocks
    of the batch under data parallelism, or, in the time-sharded layout,
    contiguous blocks of the T+1 time rows (`time_block`).  Sums over the
    rows are all-reduced over it; in the time-sharded layout it also
    carries the one-row halo between neighbouring time blocks (`halo`)
    and the broadcast of what the last time block computes alone
    (`broadcast`);
  * the 'model' axis holds blocks of the hidden axis H (tensor
    parallelism).  Sums over H are all-reduced over it, and what needs the
    whole H (the recurrent product, the h-stage's design matrix) is
    gathered over it (`all_gather`).

The JAX package gets all of this from GSPMD, which turns each sharded
reduction into a psum and each resharding into a gather or a permute
(admm_lstm_tpu/parallel/sharding.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def time_block(rows: int, index: int, world: int) -> Tuple[int, int]:
    """[lo, hi) of block `index` of `rows` time rows cut into `world`
    contiguous blocks, GSPMD's ceil split: every block holds
    ceil(rows / world) rows but the last, which holds the rest."""
    per = -(-rows // world)
    lo = min(index * per, rows)
    return lo, min(lo + per, rows)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Consensus:
    """The collectives of one mesh axis: `world` ranks in process group
    `group` (None: the default group), this rank at position `index`,
    `ranks` their global ranks in axis order (default 0 .. world-1).

    `all_sum(t)` is `dist.all_reduce(t, group=group)` on a contiguous
    copy of `t` where `t` is not contiguous (callers use the returned
    tensor); every method is the identity when the world is 1.  `calls`
    and `nbytes` count the all-reduces made and the bytes they carried,
    per rank; `counts()` adds the gathers, halos and broadcasts."""

    def __init__(self, group=None, world: int = 1, index: int = 0,
                 ranks: Optional[Sequence[int]] = None) -> None:
        self.group = group
        self.world = int(world)
        self.index = int(index)
        self.ranks = (tuple(range(self.world)) if ranks is None
                      else tuple(int(r) for r in ranks))
        self.reset_counts()

    def reset_counts(self) -> None:
        self.calls = 0
        self.nbytes = 0
        self.other = {'all_gather': [0, 0], 'halo': [0, 0],
                      'broadcast': [0, 0]}

    def counts(self) -> dict:
        """{collective: {'calls', 'bytes'}} made so far on this rank
        (bytes: what this rank sent)."""
        out = {'all_reduce': {'calls': self.calls, 'bytes': self.nbytes}}
        out.update({k: {'calls': n, 'bytes': b}
                    for k, (n, b) in self.other.items()})
        return out

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.other[kind][0] += 1
        self.other[kind][1] += _nbytes(t)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
            return t
        t = t.contiguous()
        self.calls += 1
        self.nbytes += _nbytes(t)
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
        """The global mean from each rank's mean over its block of the
        batch.  The blocks are equal in size (train_sharded pads the batch
        to a multiple of the world), so the global mean is the mean of the
        ranks' means."""
        if self.world == 1:
            return local_means
        return self.all_sum(local_means) / self.world

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's `t` in axis order.  NCCL
        gathers CUDA tensors on the card; gloo takes only CPU tensors for
        a gather, so CUDA tensors go through host copies there."""
        t = t.contiguous()
        if t.is_cuda and dist.get_backend(self.group) == 'nccl':
            out = t.new_empty((self.world,) + tuple(t.shape))
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(parts, host, group=self.group)
        return torch.stack(parts).to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's equal block of `t`, joined on `dim` in axis
        order."""
        if self.world == 1:
            return t
        self._count('all_gather', t)
        return torch.cat(self._gather(t).unbind(0), dim=dim)

    def halo(self, row: torch.Tensor) -> Optional[torch.Tensor]:
        """The `row` that the previous rank along the axis holds (None on
        the first): every rank sends its own, the last row of its time
        block, to the next."""
        if self.world == 1:
            return None
        self._count('halo', row)
        rows = self._gather(row)
        return None if self.index == 0 else rows[self.index - 1]

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """The rank at position `src` of the axis sends `t` (a contiguous
        tensor, filled in place on the others) to every rank of the
        axis."""
        if self.world == 1:
            return t
        self._count('broadcast', t)
        dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t


LOCAL = Consensus()
