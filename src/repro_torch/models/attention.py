"""GQA attention with qk-norm and RoPE; prefill and decode against a KV cache.

Counterpart of ``repro/models/attention.py``, full-attention layers only
(window, hybrid and cross attention arrive with queue A item 10).  Prefill
attention runs through ``kernels.ops.flash_mha`` (the Hopper kernel on the
card), at any prompt length, where the reference picks its jnp dense or
chunked path by length.  Decode runs the reference's dense ``_sdpa`` step.

Keys are cached post-RoPE.  A full cache is a ring of size max_seq, so slot
== position; ``decode_attention`` writes the new token's k/v into the cache
in place (the reference returns a new cache; in place saves a copy of the
whole cache every step) and returns it.

The cache is head-major, [B, KV, W, hd], where the reference's is
[B, W, KV, hd] (``models/convert.py:kv_from_jax`` maps one to the other).
Decode groups the H query heads by their kv head and multiplies against the
cache as it lies: with (b, kv) as the batch of one bmm, a head-major cache
is a view, while a position-major one would be copied every step and layer.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from .layers import NOT_PORTED, dtype_of, normal, rmsnorm
from .rope import apply_rope


def check_spec(spec: LayerSpec) -> None:
    if spec.attn != "full" or spec.cross_attn:
        raise NotImplementedError(f"attention {spec} {NOT_PORTED}")


# ------------------------------------------------------------------- init
def init_attention(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec):
    check_spec(spec)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal(generator, (d, H, hd), s, dt),
        "wk": normal(generator, (d, KV, hd), s, dt),
        "wv": normal(generator, (d, KV, hd), s, dt),
        "wo": normal(generator, (H, hd, d), 1.0 / math.sqrt(H * hd), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=generator.device)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=generator.device)
    return p


# ---------------------------------------------------------------- scoring
def _scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(cfg.head_dim)


def _softcap(scores, cap):
    if cap:
        return cap * torch.tanh(scores / cap)
    return scores


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q [B,Sq,H,hd], head-major k/v [B,KV,Sk,hd], mask broadcastable to
    [B,KV,G,Sq,Sk] -> [B,Sq,H,hd].  Query head h = kv * G + g reads kv head
    h // G, as the reference's broadcast of k/v to H heads does."""
    B, Sq, H, hd = q.shape
    KV = k.shape[1]
    qg = q.view(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bqkgd,bksd->bkgqs", qg, k) * _scale(cfg)
    scores = _softcap(scores.float(), cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bksd->bqkgd", w, v).reshape(B, Sq, H, hd)


def _project(p, x, cfg: ModelConfig, angles):
    """x [B,S,D] -> q [B,S,H,hd], k and v [B,S,KV,hd], contiguous, qk-normed and rotated."""
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(D, H * hd)).view(B, S, H, hd)
    k = (x @ p["wk"].reshape(D, KV * hd)).view(B, S, KV, hd)
    v = (x @ p["wv"].reshape(D, KV * hd)).view(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def _out(p, o, cfg: ModelConfig):
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, cfg.d_model)


# ------------------------------------------------------------------ cache
def cache_len(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> int:
    check_spec(spec)
    return max_seq


def prefill_attention(p, x, cfg: ModelConfig, spec: LayerSpec, angles, max_seq: int):
    """Full-sequence causal attention that also emits the filled KV cache."""
    B, S, _ = x.shape
    q, k, v = _project(p, x, cfg, angles)
    out = ops.flash_mha(q, k, v, causal=True, softcap=cfg.attn_softcap, scale=_scale(cfg))
    out = _out(p, out, cfg)

    cache = init_kv_cache(cfg, spec, B, max_seq, k.dtype, x.device)
    W = cache["k"].shape[2]
    for name, t in (("k", k), ("v", v)):
        if W >= S:
            cache[name][:, :, :S] = t.transpose(1, 2)
        else:
            # Ring: slots hold the last W positions p in [S-W, S), slot = p % W.
            pos = torch.arange(S - W, S, device=x.device)
            cache[name][:, :, pos % W] = t[:, pos].transpose(1, 2)
    return out, cache


def init_kv_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_seq: int, dtype, device):
    """Zeroed head-major cache [B, KV, W, hd] for one layer."""
    shape = (batch, cfg.num_kv_heads, cache_len(cfg, spec, max_seq), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cache, pos: int, cfg: ModelConfig, spec: LayerSpec, angles):
    """One-token decode. x [B,1,D]; writes this position into ``cache`` in place
    and returns (out, cache)."""
    check_spec(spec)
    q, k, v = _project(p, x, cfg, angles)
    W = cache["k"].shape[2]
    cache["k"][:, :, pos % W] = k[:, 0]
    cache["v"][:, :, pos % W] = v[:, 0]

    idx = torch.arange(W, device=x.device)
    written_at = pos - torch.remainder(pos - idx, W)  # last write position of slot idx
    mask = written_at >= 0
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg)
    return _out(p, out, cfg), cache
