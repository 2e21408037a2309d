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

- ``"vector"`` (``rmsnorm_bwd_vec_kernel``): a team of threads sized to the
  row (four warps at D = 2560, 16 threads walking four rows at D = 128)
  holds x and dy in registers, so each is read once, and each thread sums
  its columns of dscale in registers over all its rows; a block writes one
  fp32 partial row, and a second launch sums the
  blocks' rows in a fixed order.  The grid is one wave of blocks, from the
  kernel's occupancy on the current device.  On an H100 it runs qwen3-4b's
  train shapes at 56% ([2048, 2560] bf16), 64% ([65536, 128]) and 38%
  ([16384, 128]) of their bytes bound (``chip_smoke.py`` phase 3;
  ``PERF.md`` §6).
- ``"scalar"`` (``rmsnorm_bwd_kernel``): element by element, for the rest.

Both are ``torch.library`` operators, ``torch.ops.repro_torch.rmsnorm`` and
``torch.ops.repro_torch.rmsnorm_bwd``: the dispatcher sends a CUDA tensor
to the wrapper above (the kernel, or a raise), a CPU tensor to the plain
version, and a fake or meta tensor to a fake implementation that returns
the real outputs' shapes, dtypes and strides and reads no address, so a
graph tracer sees one node per kernel.
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


def _launch_bwd(var: str, x, scale, dy, eps: float):
    """Run backward kernel ``var`` on arguments that ``rmsnorm_bwd`` passed;
    count nothing."""
    d = x.shape[-1]
    rows = x.numel() // d
    vec, code = int(var == "vector"), _build.DTYPE_CODES[x.dtype]
    parts_fn = _build.function("rmsnorm_bwd", "rmsnorm_bwd_parts",
                               [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
                               restype=ctypes.c_longlong)
    fn = _build.function("rmsnorm_bwd", "rmsnorm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):  # the grid follows this device's occupancy
        parts = parts_fn(code, vec, rows, d)
        if parts < 1:
            raise RuntimeError(f"rmsnorm_bwd: the {var} kernel refuses rows {rows}, D {d}")
        dx, dscale = torch.empty_like(x), torch.empty(d, device=x.device)
        partial = torch.empty((parts, d), device=x.device)
        err = fn(code, vec, x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 dscale.data_ptr(), partial.data_ptr(), rows, d, eps,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("rmsnorm_bwd", err)
    return dx, dscale


def rmsnorm_bwd(x, scale, dy, *, eps: float = 1e-6):
    """x, dy [..., D], scale [D] fp32 -> (dx like x, dscale fp32 [D]), through
    the CUDA kernel of the variant ``variant`` names for x and scale (scalar
    also when dy is not 16-byte aligned)."""
    check_args(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() or \
            dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy must be contiguous {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros(x.shape[-1], device=x.device)
    var = variant(x, scale) if dy.data_ptr() % 16 == 0 else "scalar"
    dx, dscale = _launch_bwd(var, x, scale, dy, eps)
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.variant_launches[var] += 1
    return dx, dscale


rmsnorm_bwd.launches = 0
rmsnorm_bwd.variant_launches = {"vector": 0, "scalar": 0}


# ---------------------------------------------------------------- operators
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("rmsnorm(Tensor x, Tensor scale, float eps) -> Tensor")
_LIB.define("rmsnorm_bwd(Tensor x, Tensor scale, Tensor dy, float eps) -> (Tensor, Tensor)")
_LIB.impl("rmsnorm", lambda x, scale, eps: rmsnorm(x, scale, eps=eps), "CUDA")
_LIB.impl("rmsnorm", lambda x, scale, eps: rmsnorm_plain(x, scale, eps).contiguous(), "CPU")
_LIB.impl("rmsnorm_bwd", lambda x, scale, dy, eps: rmsnorm_bwd(x, scale, dy, eps=eps), "CUDA")


def _rmsnorm_bwd_cpu(x, scale, dy, eps):
    dx, dscale = rmsnorm_bwd_plain(x, scale, dy, eps)
    return dx.contiguous(), dscale


_LIB.impl("rmsnorm_bwd", _rmsnorm_bwd_cpu, "CPU")


@torch.library.register_fake("repro_torch::rmsnorm")
def _rmsnorm_fake(x, scale, eps):
    return x.new_empty(x.shape)


@torch.library.register_fake("repro_torch::rmsnorm_bwd")
def _rmsnorm_bwd_fake(x, scale, dy, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape[-1], dtype=torch.float32)
