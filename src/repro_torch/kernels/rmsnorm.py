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

``rmsnorm_bwd`` is the gradient (``csrc/rmsnorm_bwd.cu``): from x, scale
and dy it returns dx in x's dtype and dscale in fp32, every sum in fp32 and
dscale reduced without atomics (equal bits from run to run).  It routes by
the same rule as the forward, ``variant(x, scale)`` with dy's alignment
too, and counts in ``rmsnorm_bwd.launches`` and
``rmsnorm_bwd.variant_launches``.  ``rmsnorm_bwd_plain`` computes the same
in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_SYMBOLS = {"vector": "rmsnorm_vec_fwd", "scalar": "rmsnorm_scalar_fwd"}
_BWD_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
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


# ---------------------------------------------------------------- backward
def rmsnorm_bwd_plain(x, scale, dy, eps: float = 1e-6):
    """The gradient of ``rmsnorm_plain``: x, dy [..., D], scale [D] fp32 ->
    (dx like x, dscale fp32 [D]), with r = rsqrt(mean(x^2) + eps) and
    g = dy * scale: dx = r g - x r^3 mean(g x), dscale = sum over rows of dy x r."""
    xf, dyf = x.float(), dy.float()
    d = x.shape[-1]
    r = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / d + eps)
    g = dyf * scale.float()
    dx = r * g - xf * (r * r * r * (g * xf).sum(-1, keepdim=True) / d)
    dscale = (dyf * xf * r).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale


def rmsnorm_bwd(x, scale, dy, *, eps: float = 1e-6):
    """x, dy [..., D], scale [D] fp32 -> (dx like x, dscale fp32 [D]), through
    the CUDA kernel of the variant ``variant`` names for x and scale (scalar
    also when dy is not 16-byte aligned)."""
    check_args(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() or \
            dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy must be contiguous {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return torch.empty_like(x), torch.zeros(d, device=x.device)
    var = variant(x, scale) if dy.data_ptr() % 16 == 0 else "scalar"
    vec, code = int(var == "vector"), _build.DTYPE_CODES[x.dtype]
    parts = _build.function("rmsnorm_bwd", "rmsnorm_bwd_parts",
                            [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
                            restype=ctypes.c_longlong)(code, vec, rows, d)
    dx, dscale = torch.empty_like(x), torch.empty(d, device=x.device)
    partial = torch.empty((parts, d), device=x.device)
    fn = _build.function("rmsnorm_bwd", "rmsnorm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(code, vec, x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 dscale.data_ptr(), partial.data_ptr(), rows, d, eps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("rmsnorm_bwd", err)
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.variant_launches[var] += 1
    return dx, dscale


rmsnorm_bwd.launches = 0
rmsnorm_bwd.variant_launches = {"vector": 0, "scalar": 0}
