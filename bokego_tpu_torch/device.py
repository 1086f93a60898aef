"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the GPU.  A CUDA device raises when there is none,
    never falling back.

    Pass ``device="cpu"`` explicitly to run on the CPU (the tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` when it is a GPU (a host
    clock read after it times the device's work); nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fp32_only() -> None:
    """Keep convolutions and matmuls in full fp32 (no TF32), as the JAX
    package's float32 nets compute and as every parity check assumes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
