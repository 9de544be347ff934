"""Device selection and matmul-precision policy.

Entry points take an explicit `device` that defaults to 'cuda'.  There is
no silent CPU fallback: asking for the card on a machine without one
raises, and the CPU runs only when the caller names it.
"""

from __future__ import annotations

import contextlib

import numpy as np
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


def as_tensor(a, device) -> torch.Tensor:
    """`a` (numpy, a list or a tensor) as a float32 tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def set_matmul_precision(matmul_precision: str) -> None:
    """'highest' is full FP32 (JAX's Precision.HIGHEST): TF32 off for
    matmuls and cuDNN.  'high'/'default' allow TF32."""
    allow = matmul_precision != 'highest'
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


@contextlib.contextmanager
def matmul_precision(name: str):
    """`set_matmul_precision(name)` for the body, then the TF32 flags as
    they were on entry (a run at 'default' leaves no TF32 behind it)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    set_matmul_precision(name)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
