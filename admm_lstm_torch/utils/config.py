"""Unified configuration for the PyTorch/CUDA ADMM-LSTM port.

The same two frozen dataclasses as the JAX package
(`admm_lstm_tpu/utils/config.py`), field for field, so a config carries
across unchanged.  In this package `use_pallas_sweep` selects the
hand-written CUDA Gauss-Seidel sweep kernel (kernels/gate_sweep.py) and
`use_pallas_chol` is kept for config parity only.

Fields whose code path is not ported yet are accepted here (validation
matches the JAX package) and rejected where they would run, by
`unsupported_reason`, which `api.train` turns into NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

GATE_KEYS = ('i', 'f', 'g', 'o')
RHO_KEYS = ('i', 'f', 'g', 'o', 'c', 'h', 'y')
# Weight-decay keys: w* = input-side (x2*), v* = hidden-side (h2*), wy = readout.
BETA_KEYS = ('wi', 'vi', 'wf', 'vf', 'wg', 'vg', 'wo', 'vo', 'wy')

VARIANTS = ('fast', 'no_dual_y', 'admm_l', 'admm_s')

# The auto() composition: the single source for ADMMConfig.auto().
AUTO_FIELDS = dict(sweep_mode='jacobi', exact_weight_solve=True,
                   matmul_precision='default', adaptive_rho=True,
                   adapt_stop_epoch=10)

# The later slice of the port that brings each unported path.
SLICE_2 = 'slice 2 of the port (the turbo/auto leg)'
LATER = 'a later slice of the port'


@dataclasses.dataclass(frozen=True)
class ParameterSet:
    """Per-dataset tuned ADMM constants (reference: parameters.py:11-91).

    rho:  7 penalty coefficients keyed i,f,g,o,c,h,y.
    beta: 9 ridge (weight-decay) coefficients keyed wi,vi,...,wy.
    """

    rho: Dict[str, float]
    beta: Dict[str, float]

    def __post_init__(self) -> None:
        missing_rho = set(RHO_KEYS) - set(self.rho)
        missing_beta = set(BETA_KEYS) - set(self.beta)
        if missing_rho:
            raise ValueError(f'rho missing keys: {sorted(missing_rho)}')
        if missing_beta:
            raise ValueError(f'beta missing keys: {sorted(missing_beta)}')
        for k, v in {**self.rho, **self.beta}.items():
            if not isinstance(v, (int, float)):
                raise TypeError(f'parameter {k} must be numeric, got {type(v)}')
            if v < 0:
                raise ValueError(f'parameter {k} must be non-negative, got {v}')

    @classmethod
    def from_dict(cls, d: Dict[str, Dict[str, float]]) -> 'ParameterSet':
        return cls(rho=dict(d['rho']), beta=dict(d['beta']))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {'rho': dict(self.rho), 'beta': dict(self.beta)}


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Everything that shapes one training run."""

    variant: str = 'fast'           # one of VARIANTS
    with_dual_y: bool = False       # reference: admm.py:12 module flag
    epochs: int = 100               # reference: parameters.py:9 default_epoch
    hidden_size: int = 10
    seed: int = 0
    # STORAGE dtype of the gate/dual slabs ('float32' or 'bfloat16'); all
    # math runs in f32 (core/step.admm_step_im up/downcasts per epoch).
    dtype: str = 'float32'
    # 'highest' = full FP32 (TF32 off for matmuls and cuDNN), the parity
    # mode; 'high'/'default' allow TF32.
    matmul_precision: str = 'highest'
    # Cap on line-search doublings (every search is bounded).
    max_backtrack: int = 60
    # Final-timestep h line search bounds (reference: admm.py:447-449).
    h_theta0: float = 0.1
    h_theta_max: float = 1.0
    # Mesh: axis names and sizes; None => single device.  Not ported yet.
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ('data',)
    # Exact ridge/normal-equation weight solve.  Not ported yet.
    exact_weight_solve: bool = False
    exact_solve_max_dim: int = 160
    # The CUDA Gauss-Seidel sweep kernel (kernels/gate_sweep.interior_sweep).
    # True and 'auto' both launch it for CUDA tensors whenever T > 1; the
    # JAX package's TPU shape floor for 'auto' does not carry over.
    # False runs the plain PyTorch loop.
    use_pallas_sweep: object = 'auto'
    # Batched Cholesky kernel of the exact weight solve.  Not ported yet;
    # kept so configs carry across.
    use_pallas_chol: object = 'auto'
    # 'gauss_seidel' (reference-exact sequential sweep) or 'jacobi'
    # (time-parallel block update; not ported yet).
    sweep_mode: str = 'gauss_seidel'
    # Lipschitz-safeguarded readout step (core/step.StepRules.wy_lipschitz).
    wy_lipschitz: bool = False
    # Residual-balancing rho adaptation (core/residuals.balanced_rho),
    # frozen once the epoch count passes adapt_stop_epoch (0 = never).
    adaptive_rho: bool = False
    adapt_mu: float = 10.0
    adapt_tau: float = 2.0
    adapt_stop_epoch: int = 0
    # Stacked-variant dual damping.  Not ported yet.
    stacked_dual_decay: float = 1.0

    def __post_init__(self) -> None:
        if self.variant not in VARIANTS:
            raise ValueError(f'variant must be one of {VARIANTS}, got {self.variant!r}')
        if self.variant == 'no_dual_y' and self.with_dual_y:
            raise ValueError('no_dual_y variant cannot run with_dual_y=True')
        if self.matmul_precision not in ('highest', 'high', 'default'):
            raise ValueError(f'bad matmul_precision {self.matmul_precision!r}')
        if self.use_pallas_chol not in (True, False, 'auto'):
            raise ValueError(f'use_pallas_chol must be True, False or '
                             f"'auto', got {self.use_pallas_chol!r}")
        if self.use_pallas_sweep not in (True, False, 'auto'):
            raise ValueError(f'use_pallas_sweep must be True, False or '
                             f"'auto', got {self.use_pallas_sweep!r}")
        if self.dtype not in ('float32', 'bfloat16'):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', "
                             f'got {self.dtype!r}')

    def replace(self, **kw) -> 'ADMMConfig':
        return dataclasses.replace(self, **kw)

    @classmethod
    def turbo(cls, **kw) -> 'ADMMConfig':
        """The speed preset: Jacobi sweep + exact weight solve + default
        matmul precision (runs once slice 2 of the port lands)."""
        base = dict(sweep_mode='jacobi', exact_weight_solve=True,
                    matmul_precision='default')
        base.update(kw)
        return cls(**base)

    @classmethod
    def auto(cls, **kw) -> 'ADMMConfig':
        """turbo() plus residual-balancing rho adaptation frozen after a
        10-epoch warmup (runs once slice 2 of the port lands)."""
        base = dict(AUTO_FIELDS)
        base.update(kw)
        return cls(**base)


def unsupported_reason(config: ADMMConfig) -> Optional[str]:
    """Why this slice of the port cannot train `config`, or None."""
    if config.variant in ('admm_l', 'admm_s'):
        return f'variant {config.variant!r} arrives in {LATER}'
    if config.sweep_mode == 'jacobi':
        return f"sweep_mode='jacobi' arrives in {SLICE_2}"
    if config.exact_weight_solve:
        return f'exact_weight_solve=True arrives in {SLICE_2}'
    if config.mesh_shape is not None:
        return f'mesh_shape (data-parallel training) arrives in {LATER}'
    return None
