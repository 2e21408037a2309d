"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its plain version.

Counterpart of ``repro/kernels/flash_attention.py:99 flash_attention`` (a
Pallas TPU kernel).  ``flash_attention`` launches the Hopper kernel on CUDA
tensors and counts its launches in ``flash_attention.launches``;
``flash_attention_plain`` repeats the kernel's arithmetic in PyTorch (q
tiles, live k tiles, fp32 online softmax, -1e30 masking, rows with no live
key give 0) and is what the CPU runs.  Unlike the TPU kernel, neither needs
the lengths to divide the tiles.  The source note in the ``.cu`` file gives
the kernel's bound and design.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256


def block_rows(hd: int) -> int:
    """q and k tile rows of the kernel (``dispatch`` in the ``.cu`` file).  The
    tile decides which fully masked rows (window with Sq > Sk) meet a live k
    tile and so give a uniform average rather than 0, so the plain version
    tiles as the kernel does."""
    return 64 if hd <= 128 else 32

_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
             ctypes.c_float, _P]


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd**-0.5
    tile = block_rows(hd)
    qf = q.float().transpose(1, 2)                                   # [B,H,Sq,hd]
    kf = k.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)  # [B,H,Sk,hd]
    vf = v.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)
    out = torch.empty_like(qf)
    for q0 in range(0, Sq, tile):
        q1 = min(q0 + tile, Sq)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, H, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, q1 - q0, hd), device=q.device)
        k_end = min(Sk, q1) if causal else Sk
        k_begin = max(0, q0 - window + 1) if window is not None else 0
        for k0 in range(k_begin // tile * tile, k_end, tile):
            k1 = min(k0 + tile, Sk)
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            k_pos = torch.arange(k0, k1, device=q.device)[None, :]
            keep = torch.ones_like(s[0, 0], dtype=torch.bool)
            if causal:
                keep &= q_pos >= k_pos
            if window is not None:
                keep &= q_pos - k_pos < window
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vf[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def check_args(q, k, v, window) -> None:
    """Raise ValueError on what the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q [B,Sq,H,hd], k = v [B,Sk,KV,hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, KV, hdk = k.shape
    if Bk != B or hdk != hd or H % KV or min(B, Sq, Sk, H, KV) < 1:
        raise ValueError(f"flash_attention: mismatched shapes {tuple(q.shape)}, {tuple(k.shape)}")
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd], through the CUDA kernel."""
    check_args(q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd**-0.5
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, Sq, Sk, H, KV, hd, float(scale), int(causal),
                 window or 0, float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
