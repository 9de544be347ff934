"""ADMM state initialization.

Counterpart of `admm_lstm_tpu/core/init.py` (reference admm.py:34-60):
one forward pass seeds every primal gate trajectory and all duals start
at zero.  The JAX package copies the weights because its step donates
buffers; the port's step never writes its inputs, so no copy is needed.

Weights with a leading S axis give a state with the candidate axis
(core/state.py): S forwards at once, on inputs shared by the candidates
(B, T, I) or of their own (S, B, T, I), the JAX package's vmapped
`init_admm_state` written out; per-candidate inputs need per-candidate
weights.
"""

from __future__ import annotations

import torch

from admm_lstm_torch.core.state import (ADMMState, DualSlabs, GateSlabs,
                                        Penalties, Ridges, penalties_from,
                                        ridges_from)
from admm_lstm_torch.models.lstm import LSTMParams, lstm_forward_with_history
from admm_lstm_torch.utils.config import ADMMConfig, ParameterSet


def init_admm_state(params: LSTMParams, train_x: torch.Tensor,
                    parameter_set: ParameterSet,
                    config: ADMMConfig = ADMMConfig()) -> ADMMState:
    """Seed gates with a forward pass; zero duals; load rho/beta constants.

    The state lives on train_x's device.  Slabs are stored in
    config.dtype; `a`, the y-dual and the weights stay in the param dtype.
    With the candidate axis every candidate starts from `parameter_set`'s
    rho and beta.
    """
    batch, seq_len, input_size = train_x.shape[-3:]
    if input_size != params.input_size:
        raise ValueError(f'train_x feature dim {input_size} != model input '
                         f'size {params.input_size}')
    device = train_x.device
    dtype = params.wx.dtype
    slab_dtype = getattr(torch, config.dtype)
    params = params.to(device)

    hist = lstm_forward_with_history(params, train_x)

    lead = hist['h'].shape[:-3]         # (S,) with the candidate axis

    def to_slab(a):
        # (T+1, B, H) history -> batch-minor (T+1, H, B) slab.
        return a.transpose(-2, -1).contiguous().to(slab_dtype)

    gates = GateSlabs(i=to_slab(hist['i']), f=to_slab(hist['f']),
                      g=to_slab(hist['g']), o=to_slab(hist['o']),
                      c=to_slab(hist['c']), h=to_slab(hist['h']),
                      a=hist['a'].transpose(-2, -1).contiguous())

    def zero_slab():
        return torch.zeros(lead + (seq_len + 1, params.hidden_size, batch),
                           dtype=slab_dtype, device=device)

    duals = DualSlabs(i=zero_slab(), f=zero_slab(), g=zero_slab(),
                      o=zero_slab(), c=zero_slab(), h=zero_slab(),
                      y=torch.zeros(lead + (params.output_size, batch),
                                    dtype=dtype, device=device))

    def per_candidate(t):
        return t.expand(lead + t.shape).contiguous()

    rho = penalties_from(parameter_set, dtype, device)
    beta = ridges_from(parameter_set, dtype, device)
    if lead:
        if params.wx.dim() == 3:
            raise ValueError('per-candidate data needs per-candidate '
                             'weights (a leading S axis)')
        rho = Penalties(*map(per_candidate, rho))
        beta = Ridges(*map(per_candidate, beta))
    return ADMMState(params=params, gates=gates, duals=duals, rho=rho,
                     beta=beta, epoch=0)
