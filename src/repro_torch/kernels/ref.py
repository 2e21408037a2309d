"""Plain fp32-accumulating oracles for the kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``.  ``ssd_reference`` arrives with the
SSD slice.
"""

from __future__ import annotations

import torch


def mha_reference(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else hd**-0.5
    kh = k.repeat_interleave(G, dim=2) if G > 1 else k
    vh = v.repeat_interleave(G, dim=2) if G > 1 else v
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kh.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", w, vh.float()).to(q.dtype)


def rmsnorm_reference(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
