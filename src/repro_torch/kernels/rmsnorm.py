"""Fused RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Counterpart of ``repro/kernels/rmsnorm.py:25 rmsnorm`` (a Pallas TPU
kernel).  ``rmsnorm`` launches a Hopper kernel on CUDA tensors:
``variant(x, scale)`` names which one, by D and alignment alone.

- ``"vector"``: 16-byte loads and stores (8 bf16 or 4 fp32 values), a team
  of threads sized to the row, warp shuffles only up to D = 4096 bf16.  It
  takes D a multiple of the vector and 16-byte aligned x and scale, which
  every call on the served models' paths has.
- ``"scalar"``: element by element, for the rest.

Each launch counts in ``rmsnorm.launches`` and in
``rmsnorm.variant_launches[variant]``.  ``rmsnorm_plain`` computes the same
function in PyTorch and is what the CPU runs.  The source note in
``csrc/rmsnorm.cu`` gives the kernels' bound and design.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_SYMBOLS = {"vector": "rmsnorm_vec_fwd", "scalar": "rmsnorm_scalar_fwd"}
MAX_D = 16 * 1024  # VPT * 1024 threads of the scalar kernel in csrc/rmsnorm.cu


def variant(x, scale) -> str:
    """The kernel ``rmsnorm`` launches for ``x`` [..., D] and ``scale`` [D]:
    ``"vector"`` when D is a multiple of the 16-byte vector and x and scale
    start at 16-byte aligned addresses, ``"scalar"`` otherwise."""
    per_vector = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
    return "vector" if x.shape[-1] % per_vector == 0 and aligned else "scalar"


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


def _launch(var: str, x, scale, eps: float):
    """Run kernel ``var`` on arguments that ``check_args`` passed; count nothing."""
    out = torch.empty_like(x)  # fresh, so 16-byte aligned
    fn = _build.function("rmsnorm", _SYMBOLS[var], _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 x.numel() // x.shape[-1], x.shape[-1], eps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("rmsnorm", err)
    return out


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """x [..., D], scale [D] fp32 -> like x, through the CUDA kernel that
    ``variant(x, scale)`` names."""
    check_args(x, scale)
    if x.numel() == 0:
        return torch.empty_like(x)
    var = variant(x, scale)
    out = _launch(var, x, scale, eps)
    rmsnorm.launches += 1
    rmsnorm.variant_launches[var] += 1
    return out


rmsnorm.launches = 0
rmsnorm.variant_launches = {"vector": 0, "scalar": 0}
