"""Mamba-2 (SSD, state-space duality) mixer: prefill through the chunked
scan, decode as a one-step recurrence.

Counterpart of ``repro/models/ssm.py`` (``_dims`` ... ``decode_mamba``).
Prefill and training run the SSD through ``kernels.ops.ssd``: the Hopper
kernel on the card, which also hands back the final state for the decode
cache, and whose gradient is the backward kernel, where the reference
computes the scan in jnp (``ssd_chunked``) and differentiates that.  The
causal conv, the decode step's recurrence and the other elementwise work
stay plain PyTorch, as the JAX package has no kernel for them; the gated
norm goes through ``layers.rmsnorm``, so through the RMSNorm kernel on
the card.

Layout: d_inner = expand * d_model, heads H = d_inner / headdim (P =
headdim), state N = ssm_state, G groups share B/C across H/G heads.  The
decode cache is {"state": [B,H,P,N] fp32, "conv": [B,K-1,conv_dim]}, as the
reference's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .layers import dtype_of, normal, rmsnorm


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_headdim
    N = cfg.ssm_state
    G = cfg.ssm_groups
    conv_dim = di + 2 * G * N
    return di, H, P, N, G, conv_dim


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype | None = None):
    """Matrices (``in_proj``, ``conv_w``, ``out_proj``) in ``dtype``:
    ``cfg.dtype`` when None (serving), ``torch.float32`` for training's
    masters (every use casts them to the activations' dtype, as the
    reference's ``.astype`` does); the 1-D parameters fp32, as the
    reference keeps them."""
    d = cfg.d_model
    di, H, P, N, G, conv_dim = _dims(cfg)
    dev, dt = generator.device, dtype or dtype_of(cfg)
    proj_out = 2 * di + 2 * G * N + H  # z, x, B, C, dt
    return {
        "in_proj": normal(generator, (d, proj_out), 1.0 / math.sqrt(d), dt),
        "conv_w": normal(generator, (cfg.conv_kernel, conv_dim), 0.1, dt),
        "conv_b": torch.zeros(conv_dim, dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "D": torch.ones(H, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(H, dtype=torch.float32, device=dev),
        "norm": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": normal(generator, (di, d), 1.0 / math.sqrt(di), dt),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    di, H, P, N, G, _ = _dims(cfg)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di : 2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N :]
    return z, xBC, dt


def _split_xbc(xBC, cfg: ModelConfig):
    """xBC [B,S,conv_dim] -> x [B,S,H,P], Bm and Cm [B,S,G,N], views of xBC."""
    di, H, P, N, G, _ = _dims(cfg)
    return (
        xBC[..., :di].unflatten(-1, (H, P)),
        xBC[..., di : di + G * N].unflatten(-1, (G, N)),
        xBC[..., di + G * N :].unflatten(-1, (G, N)),
    )


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over the sequence axis. xBC [B,S,C], w [K,C]."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(K):  # K taps, as the reference
        out = out + pad[:, i : i + S] * w[i]
    return F.silu(out + b)


def apply_mamba(p, x_in, cfg: ModelConfig, *, return_cache: bool = False):
    """x_in [B,S,D] -> [B,S,D] (training or prefill).

    ``return_cache=True`` also returns the decode cache: the scan's final
    state and the conv tail.
    """
    dt_ = x_in.dtype
    B_, S = x_in.shape[:2]
    zxbcdt = x_in @ p["in_proj"].to(dt_)
    z, xBC_raw, dt_raw = _split_proj(zxbcdt, cfg)
    xBC = _causal_conv(xBC_raw, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    x, Bm, Cm = _split_xbc(xBC, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    # Pad the sequence to a chunk multiple, as the reference does; padded
    # steps get dt == 0, which makes them exact no-ops in the recurrence.
    pad = (-S) % cfg.ssm_chunk
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    A = -torch.exp(p["A_log"])
    y, final_state = ops.ssd(x, dt.to(dt_), A.to(dt_), Bm, Cm)
    y = y + p["D"].to(dt_)[:, None] * x
    y = y[:, :S].reshape(B_, S, -1)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    if not return_cache:
        return out
    # The conv tail is the last K - 1 inputs; a prompt shorter than that is
    # left-padded with zeros, as the causal conv pads it.
    K = cfg.conv_kernel
    tail = F.pad(xBC_raw, (0, 0, max(0, K - 1 - S), 0))[:, -(K - 1) :]
    return out, {"state": final_state, "conv": tail.contiguous()}


# ------------------------------------------------------------------ decode
def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    di, H, P, N, G, conv_dim = _dims(cfg)
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
    }


def decode_mamba(p, x_in, cache, cfg: ModelConfig):
    """One-token recurrent step. x_in [B,1,D] -> ([B,1,D], new cache)."""
    dt_ = x_in.dtype
    di, H, P, N, G, conv_dim = _dims(cfg)
    zxbcdt = x_in @ p["in_proj"].to(dt_)
    z, xBC_new, dt_raw = _split_proj(zxbcdt, cfg)

    # conv over [cached K-1 tail, new column]
    window = torch.cat([cache["conv"], xBC_new], dim=1)            # [B,K,conv]
    conv_out = (window * p["conv_w"].to(dt_)[None]).sum(1, keepdim=True)
    xBC = F.silu(conv_out + p["conv_b"].to(dt_))
    new_conv = window[:, 1:]

    x, Bm, Cm = _split_xbc(xBC, cfg)                               # S == 1
    x, Bm, Cm = x[:, 0], Bm[:, 0], Cm[:, 0]                        # [B,H,P], [B,G,N]
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1).float()                  # [B,H,N]
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])           # [B,H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                                         # [B,H]

    state = cache["state"] * dA[..., None, None] + torch.einsum(
        "bhp,bhn,bh->bhpn", x.float(), Bh, dt)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch).to(dt_)
    y = y + p["D"].to(dt_)[:, None] * x
    y = y.reshape(x_in.shape[0], 1, di)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    return out, {"state": state, "conv": new_conv}
