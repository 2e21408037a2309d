"""Shared layer primitives: norms, FFNs, embeddings.

Counterpart of ``repro/models/layers.py``.  Functional like the reference:
``init_*`` builds a dict of tensors from a ``torch.Generator`` (on the
generator's device), the apply functions consume it.  Matrices are stored in
``cfg.dtype``, which equals the reference's per-use ``.astype(dt)`` of its
fp32 masters and halves weight memory in bf16; norm scales stay fp32.
RMSNorm goes through ``kernels.ops.fused_rmsnorm``: the Hopper kernel on
the card, its plain version on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
def init_dense_ffn(generator: torch.Generator, cfg: ModelConfig):
    if cfg.ffn_act != "swiglu":
        raise NotImplementedError(f"ffn_act {cfg.ffn_act!r} {NOT_PORTED}")
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "w_gate": normal(generator, (d, f), 1.0 / math.sqrt(d), dt),
        "w_up": normal(generator, (d, f), 1.0 / math.sqrt(d), dt),
        "w_down": normal(generator, (f, d), 1.0 / math.sqrt(f), dt),
    }


def apply_dense_ffn(p, x, cfg: ModelConfig):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ------------------------------------------------------------ embeddings
def init_embedding(generator: torch.Generator, cfg: ModelConfig):
    if not cfg.tie_embeddings:
        raise NotImplementedError(f"untied embeddings {NOT_PORTED}")
    return {"tok": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype_of(cfg))}


def embed_tokens(p, tokens, cfg: ModelConfig):
    return p["tok"][tokens].to(dtype_of(cfg))


def lm_logits(p, x, cfg: ModelConfig):
    logits = (x @ p["tok"].to(x.dtype).T).float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits / c)
    return logits
