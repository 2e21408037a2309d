"""Multi-head Latent Attention (DeepSeek-V2) with its compressed KV cache.

Counterpart of ``repro/models/mla.py``.  Prefill decompresses ``c_kv`` into
per-head K_nope and V and runs the reference's dense masked-softmax
attention; decode is the *absorbed* step: W_uk folds into the query and W_uv
into the output, so attention runs against the compressed cache
[B, S, kv_lora] and the shared rope key [B, S, qk_rope] directly.  Scores
are scaled by 1/sqrt(qk_nope + qk_rope).  ``kv_norm`` is RMSNorm through
``layers.rmsnorm``, so through the RMSNorm kernel on the card.  The
reference's attention here reaches no Pallas kernel, and the flash kernel
takes one head dim for q, k and v (MLA has 192 for q and k, 128 for v), so
no flash kernel runs: ROADMAP.md's performance list holds that.

The cache is position-major, ``{"c_kv": [B, S, kv_lora], "k_rope": [B, S,
qk_rope]}``, the reference's layout: decode multiplies against it as it lies
(``c_kv.transpose(1, 2)`` is a view) and writes its slot in place with
``index_copy_`` at the 0-d device position, as ``attention.py`` does.
Weights are cast to the activations' dtype at each use.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from .layers import dtype_of, normal, rmsnorm
from .rope import apply_rope


def init_mla(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
             dtype: torch.dtype | None = None):
    """Matrices stored as ``dtype`` (``cfg.dtype`` by default); ``kv_norm`` fp32."""
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d, vh, lora = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                              cfg.kv_lora_rank)
    dt = dtype or dtype_of(cfg)
    s, sl = 1.0 / math.sqrt(d), 1.0 / math.sqrt(lora)
    return {
        "wq": normal(generator, (d, H, nope + rope_d), s, dt),
        "w_dkv": normal(generator, (d, lora), s, dt),
        "kv_norm": torch.ones(lora, dtype=torch.float32, device=generator.device),
        "w_kr": normal(generator, (d, rope_d), s, dt),
        "w_uk": normal(generator, (lora, H, nope), sl, dt),
        "w_uv": normal(generator, (lora, H, vh), sl, dt),
        "wo": normal(generator, (H, vh, d), 1.0 / math.sqrt(H * vh), dt),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _project_q(p, x, cfg: ModelConfig, angles):
    """x [B,S,D] -> q_nope [B,S,H,nope], q_rope [B,S,H,rope] (rotated)."""
    B, S, D = x.shape
    H, nope = cfg.num_heads, cfg.qk_nope_head_dim
    q = (x @ p["wq"].reshape(D, -1).to(x.dtype)).view(B, S, H, -1)
    return q[..., :nope], apply_rope(q[..., nope:], angles)


def _compress_kv(p, x, cfg: ModelConfig, angles):
    """x [B,S,D] -> c_kv [B,S,kv_lora] (normed), k_rope [B,S,rope] (rotated)."""
    c_kv = rmsnorm(p["kv_norm"], x @ p["w_dkv"].to(x.dtype), cfg.norm_eps)
    k_rope = apply_rope(x @ p["w_kr"].to(x.dtype), angles)
    return c_kv, k_rope


def _out(p, o, cfg: ModelConfig):
    """o [B,S,H,vh] -> [B,S,D]."""
    B, S, H, vh = o.shape
    return o.reshape(B, S, H * vh) @ p["wo"].reshape(H * vh, cfg.d_model).to(o.dtype)


def _attend(p, x, cfg: ModelConfig, angles, causal: bool):
    """Decompressed attention over the whole sequence -> (out, c_kv, k_rope)."""
    dt = x.dtype
    B, S, _ = x.shape
    H, lora = cfg.num_heads, cfg.kv_lora_rank
    q_nope, q_rope = _project_q(p, x, cfg, angles)
    c_kv, k_rope = _compress_kv(p, x, cfg, angles)
    k_nope = (c_kv @ p["w_uk"].reshape(lora, -1).to(dt)).view(B, S, H, -1)
    v = (c_kv @ p["w_uv"].reshape(lora, -1).to(dt)).view(B, S, H, -1)
    scores = (torch.einsum("bqhk,bshk->bhqs", q_nope, k_nope)
              + torch.einsum("bqhk,bsk->bhqs", q_rope, k_rope)) * _mla_scale(cfg)
    scores = scores.float()
    if causal:
        mask = torch.arange(S, device=x.device)[:, None] >= torch.arange(S, device=x.device)
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhqs,bshk->bqhk", w, v)
    return _out(p, out, cfg), c_kv, k_rope


def apply_mla(p, x, cfg: ModelConfig, spec: LayerSpec, angles, *, causal=True):
    """Training/prefill MLA (decompressed). x [B,S,D] -> [B,S,D]."""
    return _attend(p, x, cfg, angles, causal)[0]


def prefill_mla(p, x, cfg: ModelConfig, spec: LayerSpec, angles, max_seq: int):
    """MLA prefill emitting the compressed cache, zero beyond the prompt.
    The latents are computed once, for the attention and the cache alike
    (the reference computes them twice, with the same result)."""
    B, S, _ = x.shape
    out, c_kv, k_rope = _attend(p, x, cfg, angles, True)
    cache = init_mla_cache(cfg, B, max_seq, c_kv.dtype, x.device)
    cache["c_kv"][:, :S] = c_kv
    cache["k_rope"][:, :S] = k_rope
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device):
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim), dtype=dtype,
                              device=device),
    }


def decode_mla(p, x, cache, pos: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, angles):
    """Absorbed one-token decode. x [B,1,D], ``pos`` a 0-d integer tensor on
    x's device; writes the position's latents into ``cache`` in place and
    returns (out, cache)."""
    dt = x.dtype
    B = x.shape[0]
    H, nope, lora = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = _project_q(p, x, cfg, angles)           # [B,1,H,*]
    c_new, kr_new = _compress_kv(p, x, cfg, angles)          # [B,1,lora], [B,1,rope]
    slot = pos.reshape(1)
    cache["c_kv"].index_copy_(1, slot, c_new)
    cache["k_rope"].index_copy_(1, slot, kr_new)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    # W_uk absorbed into q, head by head: [H, B, nope] @ [H, nope, lora].
    q_abs = torch.bmm(q_nope.reshape(B, H, nope).transpose(0, 1),
                      p["w_uk"].to(dt).permute(1, 2, 0)).transpose(0, 1)    # [B,H,lora]
    scores = (torch.bmm(q_abs, c_kv.transpose(1, 2))
              + torch.bmm(q_rope.reshape(B, H, -1), k_rope.transpose(1, 2))) * _mla_scale(cfg)
    mask = torch.arange(c_kv.shape[1], device=x.device) <= pos
    scores = torch.where(mask, scores.float(), -1e30)
    w = torch.softmax(scores, dim=-1).to(dt)                 # [B,H,S]
    ctx = torch.bmm(w, c_kv)                                 # [B,H,lora]
    # W_uv absorbed into the output: [H, B, lora] @ [H, lora, vh].
    out = torch.bmm(ctx.transpose(0, 1), p["w_uv"].to(dt).transpose(0, 1)).transpose(0, 1)
    return _out(p, out.reshape(B, 1, H, -1), cfg), cache
