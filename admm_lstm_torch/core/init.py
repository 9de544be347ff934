"""ADMM state initialization.

Counterpart of `admm_lstm_tpu/core/init.py` (reference admm.py:34-60):
one forward pass seeds every primal gate trajectory and all duals start
at zero.  The JAX package copies the weights because its step donates
buffers; the port's step never writes its inputs, so no copy is needed.
"""

from __future__ import annotations

import torch

from admm_lstm_torch.core.state import (ADMMState, DualSlabs, GateSlabs,
                                        penalties_from, ridges_from)
from admm_lstm_torch.models.lstm import LSTMParams, lstm_forward_with_history
from admm_lstm_torch.utils.config import ADMMConfig, ParameterSet


def init_admm_state(params: LSTMParams, train_x: torch.Tensor,
                    parameter_set: ParameterSet,
                    config: ADMMConfig = ADMMConfig()) -> ADMMState:
    """Seed gates with a forward pass; zero duals; load rho/beta constants.

    The state lives on train_x's device.  Slabs are stored in
    config.dtype; `a`, the y-dual and the weights stay in the param dtype.
    """
    batch, seq_len, input_size = train_x.shape
    if input_size != params.input_size:
        raise ValueError(f'train_x feature dim {input_size} != model input '
                         f'size {params.input_size}')
    device = train_x.device
    dtype = params.wx.dtype
    slab_dtype = getattr(torch, config.dtype)
    params = params.to(device)

    hist = lstm_forward_with_history(params, train_x)

    def to_slab(a):
        # (T+1, B, H) history -> batch-minor (T+1, H, B) slab.
        return a.permute(0, 2, 1).contiguous().to(slab_dtype)

    gates = GateSlabs(i=to_slab(hist['i']), f=to_slab(hist['f']),
                      g=to_slab(hist['g']), o=to_slab(hist['o']),
                      c=to_slab(hist['c']), h=to_slab(hist['h']),
                      a=hist['a'].T.contiguous())

    def zero_slab():
        return torch.zeros((seq_len + 1, params.hidden_size, batch),
                           dtype=slab_dtype, device=device)

    duals = DualSlabs(i=zero_slab(), f=zero_slab(), g=zero_slab(),
                      o=zero_slab(), c=zero_slab(), h=zero_slab(),
                      y=torch.zeros((params.output_size, batch), dtype=dtype,
                                    device=device))

    return ADMMState(params=params, gates=gates, duals=duals,
                     rho=penalties_from(parameter_set, dtype, device),
                     beta=ridges_from(parameter_set, dtype, device),
                     epoch=0)
