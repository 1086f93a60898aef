"""The port's hand-written CUDA kernels: their wrappers and plain versions."""

from __future__ import annotations

import torch


def check_tensor(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``x`` has this dtype, shape and device and is contiguous:
    what a wrapper checks before it hands a kernel a raw pointer."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
