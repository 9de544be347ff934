"""Device selection and matmul-precision policy.

Entry points take an explicit `device` that defaults to 'cuda'.  There is
no silent CPU fallback: asking for the card on a machine without one
raises, and the CPU runs only when the caller names it.
"""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """The caller asked for the card and no CUDA device was found."""


def resolve_device(device='cuda') -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            'no CUDA device was found; pass device="cpu" (the CLI: --cpu) '
            'to run on the CPU')
    return dev


def set_matmul_precision(matmul_precision: str) -> None:
    """'highest' is full FP32 (JAX's Precision.HIGHEST): TF32 off for
    matmuls and cuDNN.  'high'/'default' allow TF32."""
    allow = matmul_precision != 'highest'
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
