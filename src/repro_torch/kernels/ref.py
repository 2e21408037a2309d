"""Plain fp32-accumulating oracles for the kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``.
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


def ssd_reference(x, dt, A, Bm, Cm):
    """Sequential SSD recurrence in fp32 (the definitionally correct oracle).

    x [b,s,h,p]; dt [b,s,h] (> 0, post-softplus); A [h] (< 0); Bm/Cm
    [b,s,g,n].  Returns y [b,s,h,p] in x's dtype.

      state_t = state_{t-1} * exp(dt_t A) + dt_t * x_t B_t^T
      y_t     = C_t . state_t
    """
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    Bh = Bm.float().repeat_interleave(rep, dim=2)  # [b,s,h,n]
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros((b, h, p, Bm.shape[3]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t] * Af)  # [b,h]
        state = state * dA[..., None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xf[:, t], Bh[:, t], dtf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def rmsnorm_reference(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
