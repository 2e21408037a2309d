"""Fused RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Counterpart of ``repro/kernels/rmsnorm.py:25 rmsnorm`` (a Pallas TPU
kernel).  ``rmsnorm`` launches the Hopper kernel on CUDA tensors and counts
its launches in ``rmsnorm.launches``; ``rmsnorm_plain`` computes the same
function in PyTorch and is what the CPU runs.  The source note in the
``.cu`` file gives the kernel's bound and design.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
MAX_D = 16 * 1024  # VPT * 1024 threads in csrc/rmsnorm.cu


def rmsnorm_plain(x, scale, eps: float = 1e-6):
    """x [..., D], scale [D] -> like x: fp32 sum of squares over D, one row at a time."""
    xf = x.float()
    ss = (xf * xf).sum(-1, keepdim=True)
    return (xf * torch.rsqrt(ss / x.shape[-1] + eps) * scale.float()).to(x.dtype)


def check_args(x, scale) -> None:
    """Raise ValueError on what the kernel does not take."""
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"rmsnorm: x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim < 1 or not 1 <= x.shape[-1] <= MAX_D:
        raise ValueError(f"rmsnorm: last dim must be in [1, {MAX_D}], got shape {tuple(x.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"rmsnorm: scale must be float32 [{x.shape[-1]}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: the kernel takes CUDA tensors on one device, got "
                         f"{x.device} and {scale.device}")


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x [..., D], scale [D] fp32 -> like x, through the CUDA kernel."""
    check_args(x, scale)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 x.numel() // x.shape[-1], x.shape[-1], eps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("rmsnorm", err)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
