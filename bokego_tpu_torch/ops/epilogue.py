"""The residual tower's trunk epilogue: wrapper, plain version, launch count.

``bias_add_relu(y, bias, residual)`` computes ``y = relu((y + bias) +
residual)`` (or ``relu(y + bias)``) in place on a channels-last activation
``y (B, C, H, W)``, each element taken to float32, added in that order and
rounded to ``y``'s dtype once.  ``models/resnet.py``'s serving copy runs it
after every trunk convolution, which cuDNN computes without its bias.  The
CUDA kernel is in ``csrc/epilogue.cu`` and replaces no Pallas kernel (the
JAX package left these ops to XLA's fusion); it is bound by bytes, and its
source's header note says how it streams them.  The wrapper takes the plain
PyTorch version only for CPU tensors (the tests); for a CUDA tensor it
launches the kernel or raises.  The wrapper counts its kernel launches
through ``utils/metrics.count`` as ``ops.bias_add_relu``, once a launch
returned without error; a run of the plain version counts nothing.
"""

from __future__ import annotations

import ctypes

import torch

from bokego_tpu_torch.utils import metrics

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p


def _lib():
    from bokego_tpu_torch.ops import build

    lib = build.load("epilogue")
    if not getattr(lib, "_bokego_typed", False):
        lib.bokego_bias_add_relu.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
        lib.bokego_bias_add_relu.restype = ctypes.c_int
        lib._bokego_typed = True
    return lib


def _check(y: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None) -> None:
    if y.dtype not in _DTYPES:
        raise TypeError(f"y: dtype {y.dtype}, expected bfloat16 or float32")
    if y.dim() != 4:
        raise ValueError(f"y: shape {tuple(y.shape)}, expected (B, C, H, W)")
    c = y.shape[1]
    if c % 8:
        raise ValueError(f"y: {c} channels, expected a multiple of 8 (16-byte vectors)")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y: not channels-last contiguous")
    if bias.dtype != y.dtype or tuple(bias.shape) != (c,) or bias.device != y.device or not bias.is_contiguous():
        raise ValueError(
            f"bias: {bias.dtype} {tuple(bias.shape)} on {bias.device}, expected a contiguous {y.dtype} ({c},) on {y.device}"
        )
    if residual is not None and (
        residual.dtype != y.dtype or residual.shape != y.shape or residual.device != y.device
        or not residual.is_contiguous(memory_format=torch.channels_last)
    ):
        raise ValueError(
            f"residual: {residual.dtype} {tuple(residual.shape)} on {residual.device}, expected a channels-last "
            f"{y.dtype} {tuple(y.shape)} on {y.device}"
        )


def bias_add_relu_plain(y: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same arithmetic in float32,
    rounded once into ``y``; returns ``y``."""
    out = y.float() + bias.float().view(1, -1, 1, 1)
    if residual is not None:
        out = out + residual.float()
    return y.copy_(torch.relu(out))


def bias_add_relu(y: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
    """``y = relu((y + bias) + residual)`` in place (without ``residual``:
    ``relu(y + bias)``); ``y`` and ``residual`` channels-last ``(B, C, H,
    W)`` of one dtype, bfloat16 or float32, ``C % 8 == 0``, ``bias (C,)``.
    Returns ``y``."""
    _check(y, bias, residual)
    if y.device.type == "cpu":
        return bias_add_relu_plain(y, bias, residual)
    if y.device.type != "cuda":
        raise ValueError(f"y: unsupported device {y.device}")
    ptrs = [y.data_ptr(), bias.data_ptr()] + ([] if residual is None else [residual.data_ptr()])
    if any(p % 16 for p in ptrs):
        raise ValueError("y, bias and residual must start on 16-byte boundaries")
    err = _lib().bokego_bias_add_relu(
        ptrs[0], ptrs[1], None if residual is None else ptrs[2], y.numel(), y.shape[1],
        _DTYPES[y.dtype], torch.cuda.current_stream(y.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bias_add_relu kernel launch failed: cudaError {err}")
    metrics.count("ops.bias_add_relu")
    return y
