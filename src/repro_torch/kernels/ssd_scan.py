"""Mamba-2 SSD chunked scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its
plain version.

Counterpart of ``repro/kernels/ssd_scan.py:65 ssd_scan`` (a Pallas TPU
kernel).  ``ssd_scan`` launches the Hopper kernel on CUDA tensors and counts
its launches in ``ssd_scan.launches``; ``ssd_scan_plain`` repeats the
kernel's arithmetic in PyTorch (the same 64-step chunks, fp32 inside) and is
what the CPU runs.  Both return the final state beside y, which the Pallas
kernel keeps in scratch and drops: the decode cache starts from it.  Neither
needs the length to divide the chunk.  The source note in the ``.cu`` file
gives the kernel's bound and design.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

CHUNK = 64     # the kernel's own chunk (L in csrc/ssd_scan.cu)
MAX_DIM = 128  # largest head dim P and state N the kernel takes

_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_I] + [_P] * 7 + [_I] * 6 + [_L] * 8 + [_P]


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


def ssd_scan(x, dt, A, Bm, Cm):
    """x [b,s,h,p], dt [b,s,h], A [h], Bm/Cm [b,s,g,n] -> (y [b,s,h,p] in x's
    dtype, final state [b,h,p,n] fp32), through the CUDA kernel."""
    check_args(x, dt, A, Bm, Cm)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    fn = _build.function("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(_build.DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, g, p, n,
                 x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), Bm.stride(0),
                 Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", err)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
