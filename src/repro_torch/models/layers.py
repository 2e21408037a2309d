"""Shared layer primitives: norms, FFNs, embeddings.

Counterpart of ``repro/models/layers.py``.  Functional like the reference:
``init_*`` builds a dict of tensors from a ``torch.Generator`` (on the
generator's device), the apply functions consume it.  The ``init_*``
functions take the matrices' storage dtype: ``cfg.dtype`` (the default) for serving,
which halves weight memory in bf16, or ``torch.float32`` for training, the
reference's fp32 masters.  Each use casts with ``.to(x.dtype)``, as the
reference's ``.astype(dt)`` does (a no-op on bf16 storage).  Norm scales,
LayerNorm biases and FFN biases stay fp32.  RMSNorm goes through
``kernels.ops.fused_rmsnorm``: the Hopper kernel on the card (both ways
when training), its plain version on the CPU.  LayerNorm (starcoder2,
whisper) is the reference's jnp arithmetic, in fp32, with no kernel: the
JAX package has no Pallas LayerNorm either.  The GELU FFN is the tanh form,
as ``jax.nn.gelu``'s default is.
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


class ShapeOnly:
    """Stands in for a ``torch.Generator`` where only shapes are wanted: the
    ``init_*`` functions then build meta tensors and draw nothing."""

    device = torch.device("meta")


def normal(generator: torch.Generator, shape, std: float, dtype: torch.dtype):
    """N(0, std^2) drawn in fp32 from ``generator`` on its device, stored as
    ``dtype``; an empty meta tensor for a ``ShapeOnly`` generator."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * std).to(dtype)


# ----------------------------------------------------------------- norms
def _check_norm(cfg: ModelConfig) -> None:
    if cfg.norm_type not in ("rms", "layer"):
        raise NotImplementedError(f"norm_type {cfg.norm_type!r} {NOT_PORTED}")


def init_norm(cfg: ModelConfig, device):
    """fp32 ``scale`` (ones), and for LayerNorm an fp32 ``bias`` (zeros)."""
    _check_norm(cfg)
    p = {"scale": torch.ones(cfg.d_model, dtype=torch.float32, device=device)}
    if cfg.norm_type == "layer":
        p["bias"] = torch.zeros(cfg.d_model, dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    """RMSNorm through the kernel, or LayerNorm as the reference computes it
    (``repro/models/layers.py:30-35``): in fp32, the mean, the centred
    variance, ``rsqrt(var + eps)``, then scale and bias, cast back to x's
    dtype."""
    _check_norm(cfg)
    if cfg.norm_type == "rms":
        return ops.fused_rmsnorm(x, p["scale"], eps=cfg.norm_eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def rmsnorm(scale, x, eps: float = 1e-6):
    """Bare RMSNorm used for qk-norm (the reference's argument order)."""
    return ops.fused_rmsnorm(x, scale, eps=eps)


# ------------------------------------------------------------------ FFN
def init_dense_ffn(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None, d_ff: int | None = None):
    """SwiGLU's ``w_gate``, ``w_up``, ``w_down``, or GELU's ``w_up``, ``b_up``,
    ``w_down``, ``b_down`` with fp32 zero biases.  ``d_ff`` overrides
    ``cfg.d_ff``, as the reference's does for the MoE's shared experts."""
    if cfg.ffn_act not in ("swiglu", "gelu"):
        raise NotImplementedError(f"ffn_act {cfg.ffn_act!r} {NOT_PORTED}")
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dtype = dtype or dtype_of(cfg)
    if cfg.ffn_act == "swiglu":
        return {
            "w_gate": normal(generator, (d, f), 1.0 / math.sqrt(d), dtype),
            "w_up": normal(generator, (d, f), 1.0 / math.sqrt(d), dtype),
            "w_down": normal(generator, (f, d), 1.0 / math.sqrt(f), dtype),
        }
    dev = generator.device
    return {
        "w_up": normal(generator, (d, f), 1.0 / math.sqrt(d), dtype),
        "b_up": torch.zeros(f, dtype=torch.float32, device=dev),
        "w_down": normal(generator, (f, d), 1.0 / math.sqrt(f), dtype),
        "b_down": torch.zeros(d, dtype=torch.float32, device=dev),
    }


def apply_dense_ffn(p, x, cfg: ModelConfig):
    """SwiGLU, or GELU with biases in the tanh form (``jax.nn.gelu``'s
    default; ``F.gelu``'s default is the erf form, up to 4.7e-4 away)."""
    dt = x.dtype
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


# ------------------------------------------------------------ embeddings
def init_embedding(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None):
    """The token table, and the output head ``"head"`` when the config does
    not tie them."""
    dtype = dtype or dtype_of(cfg)
    p = {"tok": normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype)}
    if not cfg.tie_embeddings:
        p["head"] = normal(generator, (cfg.vocab_size, cfg.d_model), 0.02, dtype)
    return p


def embed_tokens(p, tokens, cfg: ModelConfig):
    return p["tok"][tokens].to(dtype_of(cfg))


def lm_logits(p, x, cfg: ModelConfig):
    logits = (x @ p.get("head", p["tok"]).to(x.dtype).T).float()
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
    (``torch.utils.checkpoint``; nothing here draws random numbers, so no
    RNG state is saved), so live logits are [B, chunk, V].  The
    table (the untied ``"head"`` where there is one, else ``"tok"``) is
    cast to x's dtype once, outside the loop.  The sequence is padded to a
    multiple of the chunk with ``ignore_index`` labels.  x is
    the final-normed hidden state aligned so that position i predicts
    labels[i] (callers shift)."""
    table = params.get("head", params["tok"]).to(x.dtype)
    B, S, D = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
    total = torch.zeros((), device=x.device)
    for i in range(0, S + pad, c):
        total = total + checkpoint(_xent_sum, x[:, i:i + c], table, labels[:, i:i + c],
                                   cfg.final_softcap, ignore_index, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (labels != ignore_index).sum().clamp(min=1)
