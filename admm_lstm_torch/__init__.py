"""admm_lstm_torch: the ADMM-LSTM trainer ported to PyTorch and CUDA.

The port of `admm_lstm_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100,
kept beside it with the same module names and layout.  It imports torch
and numpy, never jax, and nothing of `admm_lstm_tpu`.  Every TPU kernel of
its paths is a hand-written CUDA kernel: the Gauss-Seidel and Jacobi
interior sweeps (csrc/gate_sweep.cu) and the batched Cholesky solve and
inverse of the exact weight solve (csrc/cholesky.cu); beside each sits a
plain PyTorch version that the CPU path and the tests use.

Layout:
  core/      ADMMState + the one-epoch `admm_step`
  solvers/   closed-form / prox-linear / exact (normal-equation) solvers
  kernels/   CUDA kernels (ctypes-bound) with their plain versions
  models/    the LSTM-Linear model as plain functions
  data/      dataset loaders (numpy)
  ckpt/      checkpoint/resume of the full ADMM state, .npz models
  tune.py    the rho search
  utils/     config, logging, timing, plotting, device policy
"""

__version__ = '0.1.0'

from admm_lstm_torch.utils.config import ADMMConfig, ParameterSet
from admm_lstm_torch.params import example_parameter_dictionary, default_epoch
from admm_lstm_torch.core.state import ADMMState
from admm_lstm_torch.core.step import admm_step, make_admm_step
from admm_lstm_torch.core.init import init_admm_state
from admm_lstm_torch.models.lstm import (LSTMParams, init_lstm_params,
                                         lstm_forward, params_from_numpy)
from admm_lstm_torch.api import ADMMBasedOptimizer, train

__all__ = [
    'ADMMConfig', 'ParameterSet', 'ADMMState',
    'admm_step', 'make_admm_step', 'init_admm_state',
    'LSTMParams', 'lstm_forward', 'init_lstm_params', 'params_from_numpy',
    'ADMMBasedOptimizer', 'train',
    'example_parameter_dictionary', 'default_epoch',
]
