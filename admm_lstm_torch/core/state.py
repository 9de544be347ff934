"""The ADMM optimizer state as NamedTuples of tensors.

Counterpart of `admm_lstm_tpu/core/state.py`, with the same layout:
  * Gate/dual slabs are TIME-MAJOR, BATCH-MINOR ``(T+1, H, B)``.  On the
    GPU this is also the layout the sweep kernel wants: one thread per
    batch column means neighbouring threads touch neighbouring addresses,
    so every slab access coalesces.  Keeping the JAX layout also lets the
    parity tests compare like with like.  (The reference uses (B, T+1, H);
    the converters below restore it for the golden fixtures.)
  * Row 0 of every slab is the zero initial state and is never written.
  * `a` and the y-dual are out-minor (O, B).
  * The four gate weights are stacked (4, I, H) / (4, H, H).

`epoch` is a host int: the training loop knows it without a device sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from admm_lstm_torch.models.lstm import LSTMParams
from admm_lstm_torch.utils.config import RHO_KEYS, ParameterSet


class GateSlabs(NamedTuple):
    """Primal auxiliary variables. i,f,g,o,c,h: (T+1, H, B); a: (O, B)."""

    i: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    o: torch.Tensor
    c: torch.Tensor
    h: torch.Tensor
    a: torch.Tensor


class DualSlabs(NamedTuple):
    """Lagrange multipliers. i..h: (T+1, H, B); y: (O, B)."""

    i: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    o: torch.Tensor
    c: torch.Tensor
    h: torch.Tensor
    y: torch.Tensor


class Penalties(NamedTuple):
    """The 7 rho penalty coefficients as 0-d tensors."""

    i: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    o: torch.Tensor
    c: torch.Tensor
    h: torch.Tensor
    y: torch.Tensor

    def stacked_ifgo(self) -> torch.Tensor:
        return torch.stack([self.i, self.f, self.g, self.o])


class Ridges(NamedTuple):
    """The 9 beta ridge coefficients: per-gate input/hidden sides + readout."""

    x: torch.Tensor   # (4,) for x2i, x2f, x2g, x2o
    h: torch.Tensor   # (4,) for h2i, h2f, h2g, h2o
    wy: torch.Tensor  # 0-d


class ADMMState(NamedTuple):
    params: LSTMParams
    gates: GateSlabs
    duals: DualSlabs
    rho: Penalties
    beta: Ridges
    epoch: int

    @property
    def seq_len(self) -> int:
        return self.gates.i.shape[0] - 1

    @property
    def batch_size(self) -> int:
        return self.gates.i.shape[2]

    @property
    def hidden_size(self) -> int:
        return self.gates.i.shape[1]


def penalties_from(params: ParameterSet, dtype=torch.float32,
                   device='cpu') -> Penalties:
    # Extra rho keys (e.g. 'z' for the stacked variant) are not core keys.
    return Penalties(**{k: torch.tensor(v, dtype=dtype, device=device)
                        for k, v in params.rho.items() if k in RHO_KEYS})


def ridges_from(params: ParameterSet, dtype=torch.float32,
                device='cpu') -> Ridges:
    b = params.beta
    return Ridges(
        x=torch.tensor([b['wi'], b['wf'], b['wg'], b['wo']], dtype=dtype,
                       device=device),
        h=torch.tensor([b['vi'], b['vf'], b['vg'], b['vo']], dtype=dtype,
                       device=device),
        wy=torch.tensor(b['wy'], dtype=dtype, device=device),
    )


def to_batch_major(slab: torch.Tensor) -> torch.Tensor:
    """(T+1, H, B) -> (B, T+1, H): the reference's layout (admm.py:171)."""
    return slab.permute(2, 0, 1)


def from_batch_major(slab: torch.Tensor) -> torch.Tensor:
    """(B, T+1, H) -> (T+1, H, B)."""
    return slab.permute(1, 2, 0)
