"""Shared layer primitives: norms, FFNs, embeddings.

Counterpart of ``repro/models/layers.py``.  Functional like the reference:
``init_*`` builds a dict of tensors from a ``torch.Generator`` (on the
generator's device), the apply functions consume it.  The ``init_*``
functions take the matrices' storage dtype: ``cfg.dtype`` (the default) for serving,
which halves weight memory in bf16, or ``torch.float32`` for training, the
reference's fp32 masters.  Each use casts with ``.to(x.dtype)``, as the
reference's ``.astype(dt)`` does (a no-op on bf16 storage).  Norm scales
stay fp32.  RMSNorm goes through ``kernels.ops.fused_rmsnorm``: the Hopper
kernel on the card (both ways when training), its plain version on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NOT_PORTED = "is not yet ported, see ROADMAP.md queue A item 10"


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(generator: torch.Generator, shape, std: float, dtype: torch.dtype):
    """N(0, std^2) drawn in fp32 from ``generator`` on its device, stored as ``dtype``."""
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * std).to(dtype)


# ----------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, device):
    if cfg.norm_type != "rms":
        raise NotImplementedError(f"norm_type {cfg.norm_type!r} {NOT_PORTED}")
    return {"scale": torch.ones(cfg.d_model, dtype=torch.float32, device=device)}


def apply_norm(p, x, cfg: ModelConfig):
    if cfg.norm_type != "rms":
        raise NotImplementedError(f"norm_type {cfg.norm_type!r} {NOT_PORTED}")
    return ops.fused_rmsnorm(x, p["scale"], eps=cfg.norm_eps)


def rmsnorm(scale, x, eps: float = 1e-6):
    """Bare RMSNorm used for qk-norm (the reference's argument order)."""
    return ops.fused_rmsnorm(x, scale, eps=eps)


# ------------------------------------------------------------------ FFN
def init_dense_ffn(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None):
    if cfg.ffn_act != "swiglu":
        raise NotImplementedError(f"ffn_act {cfg.ffn_act!r} {NOT_PORTED}")
    d, f = cfg.d_model, cfg.d_ff
    dtype = dtype or dtype_of(cfg)
    return {
        "w_gate": normal(generator, (d, f), 1.0 / math.sqrt(d), dtype),
        "w_up": normal(generator, (d, f), 1.0 / math.sqrt(d), dtype),
        "w_down": normal(generator, (f, d), 1.0 / math.sqrt(f), dtype),
    }


def apply_dense_ffn(p, x, cfg: ModelConfig):
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


# ------------------------------------------------------------ embeddings
def init_embedding(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None):
    if not cfg.tie_embeddings:
        raise NotImplementedError(f"untied embeddings {NOT_PORTED}")
    return {"tok": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                          dtype or dtype_of(cfg))}


def embed_tokens(p, tokens, cfg: ModelConfig):
    return p["tok"][tokens].to(dtype_of(cfg))


def lm_logits(p, x, cfg: ModelConfig):
    logits = (x @ p["tok"].to(x.dtype).T).float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------- losses
def cross_entropy(logits, labels, ignore_index: int = -1):
    """Mean CE over non-ignored positions.  logits fp32 [..., V], labels int."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0)
    ll = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


def _xent_sum(xc, table, lc, final_softcap, ignore_index: int):
    """Summed CE of one chunk: xc [B,c,D], table [V,D] in xc's dtype, lc [B,c]."""
    logits = (xc @ table.T).float()
    if final_softcap:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    mask = lc != ignore_index
    safe = torch.where(mask, lc, 0)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - ll) * mask).sum()


def chunked_softmax_xent(x, params, labels, cfg: ModelConfig, chunk: int = 256,
                         ignore_index: int = -1):
    """CE without materialising [B, S, V] logits: chunks of ``chunk`` positions,
    each's fp32 logits reduced to a summed CE and recomputed in backward
    (``torch.utils.checkpoint``), so live logits are [B, chunk, V].  The
    table is cast to x's dtype once, outside the loop.  The sequence is
    padded to a multiple of the chunk with ``ignore_index`` labels.  x is
    the final-normed hidden state aligned so that position i predicts
    labels[i] (callers shift)."""
    table = params["tok"].to(x.dtype)
    B, S, D = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
    total = torch.zeros((), device=x.device)
    for i in range(0, S + pad, c):
        total = total + checkpoint(_xent_sum, x[:, i:i + c], table, labels[:, i:i + c],
                                   cfg.final_softcap, ignore_index, use_reentrant=False)
    return total / (labels != ignore_index).sum().clamp(min=1)
