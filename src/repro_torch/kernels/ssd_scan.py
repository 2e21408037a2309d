"""Mamba-2 SSD chunked scan: two CUDA kernels and their plain version.

Counterpart of ``repro/kernels/ssd_scan.py:65 ssd_scan`` (a Pallas TPU
kernel).  ``ssd_scan`` launches a Hopper kernel on CUDA tensors:
``variant(x, Bm, Cm)`` names which one, by type, shape and layout alone.

- ``"tc"`` (``csrc/ssd_scan_tc.cu``): bf16 with P and N multiples of 8, on
  the tensor cores (mma.sync, fp32 sums), a block for each 32 rows of a
  (batch, head)'s state, 64-step chunks, after a prepass that computes
  C B^T once per (batch, chunk, group) into fp32 scratch this wrapper
  allocates.  It rounds three operands to bf16 (see the source note) and
  copies 16-byte rows, so it takes 16-byte aligned x, B and C whose batch
  and sequence strides are multiples of 8 elements, as every call on the
  served model's path has.
- ``"simt"`` (``csrc/ssd_scan.cu``): fp32, whose 1e-4 parity needs IEEE
  fp32 products (TF32 keeps about three decimal digits), and the bf16
  inputs that the tc kernel does not take; on the CUDA cores, a block for
  each (batch, head), 64-step chunks.

Each launch counts in ``ssd_scan.launches`` and in
``ssd_scan.variant_launches[variant]``.  ``ssd_scan_plain`` repeats the
chunked arithmetic in PyTorch, fp32 throughout (64-step chunks too) and is
what the CPU runs; the kernels are held to it on the card.  All three
return the final state beside y, which the Pallas kernel keeps in scratch
and drops: the decode cache starts from it.  None needs the length to
divide the chunk, and the chunk does not change the function.  The source
notes in the ``.cu`` files give each kernel's bound and design.

The ``torch.library`` operator ``repro_torch.ssd_scan`` carries it: the
dispatcher sends a CUDA tensor to ``ssd_scan`` (the kernel, or a raise), a
CPU tensor to the plain version, and a fake or meta tensor to a fake
implementation that returns the real outputs' shapes, dtypes and strides
(``variant`` reads addresses, so it runs only in the wrapper).  It has no
gradient yet (ROADMAP queue B item 3).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

CHUNK = 64     # both kernels' own chunk (L in csrc/ssd_scan.cu and ssd_scan_tc.cu)
MAX_DIM = 128  # largest head dim P and state N the kernels take
_LIBS = {"tc": "ssd_scan_tc", "simt": "ssd_scan"}


def variant(x, Bm, Cm) -> str:
    """The kernel ``ssd_scan`` launches for x [b,s,h,p] and Bm, Cm [b,s,g,n]:
    ``"tc"`` for bf16 with p and n multiples of 8 whose x, Bm and Cm start at
    16-byte aligned addresses with batch and sequence strides that are
    multiples of 8 elements, ``"simt"`` otherwise."""
    rows = all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
               for t in (x, Bm, Cm))
    return ("tc" if x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and Bm.shape[-1] % 8 == 0 and rows else "simt")

_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_I] + [_P] * 7 + [_I] * 6 + [_L] * 8 + [_P]  # simt's ssd_scan_fwd
_TC_ARGTYPES = [_I] + [_P] * 8 + [_I] * 6 + [_L] * 8 + [_P]  # ssd_scan_tc_fwd: + C B^T scratch


def ssd_scan_plain(x, dt, A, Bm, Cm):
    """x [b,s,h,p], dt [b,s,h] (> 0), A [h] (< 0), Bm/Cm [b,s,g,n] ->
    (y [b,s,h,p] in x's dtype, final state [b,h,p,n] fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    rep = h // Bm.shape[2]
    dtf = dt.float()
    xdt = (x.float() * dtf[..., None]).transpose(1, 2)           # [b,h,s,p]
    dA = (dtf * A.float()).transpose(1, 2)                       # [b,h,s]
    Bh = Bm.float().repeat_interleave(rep, dim=2).transpose(1, 2)  # [b,h,s,n]
    Ch = Cm.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, CHUNK):
        c1 = min(c0 + CHUNK, s)  # a ragged last chunk equals a zero-padded one
        xc, bc, cc = xdt[:, :, c0:c1], Bh[:, :, c0:c1], Ch[:, :, c0:c1]
        cum = dA[:, :, c0:c1].cumsum(-1)                         # [b,h,c]
        lower = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool, device=x.device).tril()
        # Mask before the exp: above the diagonal the differences are positive.
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~lower, -torch.inf)
        decay_in = torch.exp(diff)                                # [b,h,c,c]
        yc = ((cc @ bc.transpose(-1, -2)) * decay_in) @ xc
        yc = yc + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
        decay_out = torch.exp(cum[..., -1:] - cum)                # [b,h,c]
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + (xc * decay_out[..., None]).transpose(-1, -2) @ bc)
        y[:, :, c0:c1] = yc
    return y.transpose(1, 2).to(x.dtype), state


def check_args(x, dt, A, Bm, Cm) -> None:
    """Raise ValueError on what the kernel does not take."""
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: want x [b,s,h,p], dt [b,s,h], A [h], Bm = Cm [b,s,g,n], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or tuple(Bm.shape[:2]) != (b, s)
            or min(b, s, h, p, g, n) < 1 or h % g):
        raise ValueError(f"ssd_scan: mismatched shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}")
    if p > MAX_DIM or n > MAX_DIM:
        raise ValueError(f"ssd_scan: head dim and state must be at most {MAX_DIM}, got {p}, {n}")
    if x.dtype not in _build.DTYPE_CODES or any(t.dtype != x.dtype for t in (dt, A, Bm, Cm)):
        raise ValueError(f"ssd_scan: x, dt, A, Bm, Cm must share float32 or bfloat16, got "
                         f"{[str(t.dtype) for t in (x, dt, A, Bm, Cm)]}")
    # Batch and sequence may be strided (views into the conv output); the rest is dense.
    if not (x[0, 0].is_contiguous() and dt[0, 0].is_contiguous() and A.is_contiguous()
            and Bm[0, 0].is_contiguous() and Cm[0, 0].is_contiguous()):
        raise ValueError("ssd_scan: the axes after batch and sequence must be contiguous")
    if x.device.type != "cuda" or any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError(f"ssd_scan: the kernel takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in (x, dt, A, Bm, Cm)]}")


def _launch(var: str, x, dt, A, Bm, Cm):
    """Run kernel ``var`` on arguments that ``check_args`` passed; count nothing."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = _LIBS[var]
    ptrs = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr()]
    if var == "tc":  # the prepass's C B^T, one fp32 chunk-square per (batch, group, chunk)
        cb = torch.empty((b, g, -(-s // CHUNK), CHUNK, CHUNK), dtype=torch.float32,
                         device=x.device)
        ptrs.append(cb.data_ptr())
    fn = _build.function(lib, f"{lib}_fwd", _TC_ARGTYPES if var == "tc" else _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(_build.DTYPE_CODES[x.dtype], *ptrs, y.data_ptr(), state.data_ptr(), b, s, h, g,
                 p, n, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), Bm.stride(0),
                 Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err)
    return y, state


def ssd_scan(x, dt, A, Bm, Cm):
    """x [b,s,h,p], dt [b,s,h], A [h], Bm/Cm [b,s,g,n] -> (y [b,s,h,p] in x's
    dtype, final state [b,h,p,n] fp32), through the CUDA kernel that
    ``variant(x, Bm, Cm)`` names."""
    check_args(x, dt, A, Bm, Cm)
    var = variant(x, Bm, Cm)
    y, state = _launch(var, x, dt, A, Bm, Cm)
    ssd_scan.launches += 1
    ssd_scan.variant_launches[var] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.variant_launches = {"tc": 0, "simt": 0}


# ---------------------------------------------------------------- operator
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm) -> (Tensor, Tensor)")
_LIB.impl("ssd_scan", ssd_scan, "CUDA")


def _ssd_scan_cpu(x, dt, A, Bm, Cm):
    y, state = ssd_scan_plain(x, dt, A, Bm, Cm)
    return y.contiguous(), state


_LIB.impl("ssd_scan", _ssd_scan_cpu, "CPU")


@torch.library.register_fake("repro_torch::ssd_scan")
def _ssd_scan_fake(x, dt, A, Bm, Cm):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)),
            x.new_empty((b, h, p, Bm.shape[3]), dtype=torch.float32))
