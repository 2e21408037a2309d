"""Flash attention forward: two CUDA kernels and their plain version.

Counterpart of ``repro/kernels/flash_attention.py:99 flash_attention`` (a
Pallas TPU kernel).  ``flash_attention`` launches a Hopper kernel on CUDA
tensors: ``variant(dtype, hd)`` names which one, and nothing else decides.

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 at head dim 64 or
  128, on the tensor cores, tiles of 128 q rows by 128 keys.  It rounds P to
  bf16 before P.V (the TPU kernel's P.V is fp32; see the source note).
- ``"simt"`` (``csrc/flash_attention.cu``): everything else the wrapper takes
  -- fp32 (whose 2e-5 parity needs IEEE fp32 products, not TF32 tensor
  cores) and bf16 at head dims other than 64 and 128 (16 to 256 in steps of
  16) -- on the CUDA cores, tiles of 64 rows (32 above head dim 128).

Each launch counts in ``flash_attention.launches`` and in
``flash_attention.variant_launches[variant]``.  A launch that fails raises;
nothing gives way to the other variant or to the plain version.
``flash_attention_plain`` repeats the kernels' arithmetic in PyTorch (q
tiles, live k tiles at the variant's tile shape, fp32 online softmax with
P kept in fp32, -1e30 masking, rows with no live key give 0) and is what
the CPU runs.  Unlike the TPU kernel, none needs the lengths to divide the
tiles.  The source notes in the ``.cu`` files give each kernel's bound and
design.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128)


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel ``flash_attention`` launches for q/k/v of ``dtype`` and head
    dim ``hd``: ``"wgmma"`` for bf16 at hd 64 or 128, ``"simt"`` otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "simt"


def block_shape(dtype: torch.dtype, hd: int) -> tuple[int, int]:
    """(q rows, keys) of a tile of the kernel that ``variant`` picks.  The tile
    decides which fully masked rows (window with Sq > Sk) meet a live k tile
    and so give a uniform average rather than 0, so the plain version tiles
    as the kernel does."""
    if variant(dtype, hd) == "wgmma":
        return 128, 128
    t = 64 if hd <= 128 else 32  # ``dispatch`` in csrc/flash_attention.cu
    return t, t


_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
             ctypes.c_float, _P]


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd**-0.5
    bq, bk = block_shape(q.dtype, hd)
    qf = q.float().transpose(1, 2)                                   # [B,H,Sq,hd]
    kf = k.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)  # [B,H,Sk,hd]
    vf = v.float().repeat_interleave(H // KV, dim=2).transpose(1, 2)
    out = torch.empty_like(qf)
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, H, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, q1 - q0, hd), device=q.device)
        k_end = min(Sk, q1) if causal else Sk
        k_begin = max(0, q0 - window + 1) if window is not None else 0
        for k0 in range(k_begin // bk * bk, k_end, bk):
            k1 = min(k0 + bk, Sk)
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
    if variant(q.dtype, hd) == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the wgmma kernel loads 16-byte chunks, so q, k and "
                         "v must start at 16-byte aligned addresses")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd], through the CUDA kernel
    that ``variant(q.dtype, hd)`` names."""
    check_args(q, k, v, window)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd**-0.5
    out = torch.empty_like(q)
    var = variant(q.dtype, hd)
    lib = "flash_attention_wgmma" if var == "wgmma" else "flash_attention"
    fn = _build.function(lib, f"{lib}_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, Sq, Sk, H, KV, hd, float(scale), int(causal),
                 window or 0, float(softcap or 0.0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err)
    flash_attention.launches += 1
    flash_attention.variant_launches[var] += 1
    return out


flash_attention.launches = 0
flash_attention.variant_launches = {"wgmma": 0, "simt": 0}
