"""GQA attention with qk-norm and RoPE; prefill and decode against a KV cache.

Counterpart of ``repro/models/attention.py`` for full, sliding-window and
hybrid layers (a hybrid layer's attention branch is a window or full
attention layer's; ``models/transformer.py`` runs its Mamba-2 branch); cross
attention waits for queue A item 10.  Training (``apply_attention``) and
prefill attention run through ``kernels.ops.flash_mha`` (the Hopper kernels
on the card, forward and, when training, backward), at any length, with
the layer's window, where the reference picks its jnp ``mha_dense`` or
``mha_chunked`` by length; those compute the same function and are not
ported.  Decode runs the reference's dense ``_sdpa`` step.
Weights are cast to the activations' dtype at each use (a no-op on bf16
storage; fp32 masters when training).

Keys are cached post-RoPE.  Every cache is a ring: a full layer's of size
max_seq, so slot == position, a window layer's of size min(max_seq,
window), which holds the last ``window`` positions, position p at slot
p % W, as the reference's does.  ``decode_attention`` writes the new
token's k/v into the cache in place (the reference returns a new cache; in
place saves a copy of the whole cache every step) and returns it.  Its position is a 0-d integer
tensor on the device, as the reference's is an int32 scalar: no decode
step reads it on the host.

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
    if spec.attn not in ("full", "window", "hybrid") or spec.cross_attn:
        raise NotImplementedError(f"attention {spec} {NOT_PORTED}")


def _window(spec: LayerSpec) -> int | None:
    """The layer's sliding window, as the reference reads it: window and
    hybrid layers that set one; None attends to every earlier position."""
    return spec.window if spec.attn in ("window", "hybrid") else None


# ------------------------------------------------------------------- init
def init_attention(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
                   dtype: torch.dtype | None = None):
    """Matrices stored as ``dtype`` (``cfg.dtype`` by default); the qk-norm
    scales fp32."""
    check_spec(spec)
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype or dtype_of(cfg)
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
    q = (x @ p["wq"].reshape(D, H * hd).to(x.dtype)).view(B, S, H, hd)
    k = (x @ p["wk"].reshape(D, KV * hd).to(x.dtype)).view(B, S, KV, hd)
    v = (x @ p["wv"].reshape(D, KV * hd).to(x.dtype)).view(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def _out(p, o, cfg: ModelConfig):
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, cfg.d_model).to(o.dtype)


# ----------------------------------------------------------------- train
def apply_attention(p, x, cfg: ModelConfig, spec: LayerSpec, angles):
    """Full-sequence causal attention for training: x [B,S,D] -> [B,S,D].
    The reference's ``mha_dense``/``mha_chunked`` become the flash kernel at
    every S, with the layer's window, through ``ops.flash_mha``.  It is
    differentiable without a window; the gradient of a window layer raises
    (``check_bwd_supported``) until the window backward lands (ROADMAP A10)."""
    check_spec(spec)
    q, k, v = _project(p, x, cfg, angles)
    out = ops.flash_mha(q, k, v, causal=True, window=_window(spec), softcap=cfg.attn_softcap,
                        scale=_scale(cfg))
    return _out(p, out, cfg)


# ------------------------------------------------------------------ cache
def cache_len(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> int:
    """Slots of the layer's ring: min(max_seq, window) for a layer with a
    window, else max_seq."""
    check_spec(spec)
    window = _window(spec)
    return max_seq if window is None else min(max_seq, window)


def prefill_attention(p, x, cfg: ModelConfig, spec: LayerSpec, angles, max_seq: int):
    """Full-sequence causal attention that also emits the filled KV cache.
    The ring's slots are written with tensor indices, so nothing here reads
    a value back to the host (``serve --plan`` traces it on fake tensors)."""
    B, S, _ = x.shape
    q, k, v = _project(p, x, cfg, angles)
    out = ops.flash_mha(q, k, v, causal=True, window=_window(spec), softcap=cfg.attn_softcap,
                        scale=_scale(cfg))
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


def decode_attention(p, x, cache, pos: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                     angles):
    """One-token decode. x [B,1,D], pos a 0-d integer tensor on x's device
    (``Model.decode_step`` makes it one); writes this position into ``cache``
    in place and returns (out, cache).  The slot is written with
    ``index_copy_`` at a 1-element index, never by Python indexing with
    ``pos``, which would read it back to the host (a sync on the card, a
    data-dependent error under a fake-tensor trace)."""
    check_spec(spec)
    q, k, v = _project(p, x, cfg, angles)
    W = cache["k"].shape[2]
    slot = torch.remainder(pos, W).reshape(1)
    cache["k"].index_copy_(2, slot, k.transpose(1, 2))
    cache["v"].index_copy_(2, slot, v.transpose(1, 2))

    # The reference's mask is written_at >= 0, where slot idx was last
    # written at pos - (pos - idx) mod W.  That is >= 0 exactly when idx <=
    # pos, for a full cache and a ring alike: before the ring wraps (pos <
    # W) slot idx holds position idx, and from pos = W - 1 on every slot
    # holds one of the last W positions, which the window keeps.
    mask = torch.arange(W, device=x.device) <= pos
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg)
    return _out(p, out, cfg), cache
