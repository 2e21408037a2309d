"""GQA attention with qk-norm and RoPE; prefill and decode against a KV cache.

Counterpart of ``repro/models/attention.py`` for full, sliding-window and
hybrid layers (a hybrid layer's attention branch is a window or full
attention layer's; ``models/transformer.py`` runs its Mamba-2 branch), and
for an encoder-decoder's cross attention.  Training (``apply_attention``)
and prefill attention run through ``kernels.ops.flash_mha`` (the Hopper
kernels on the card, forward and, when training, backward), at any length,
with the layer's window, causal or not (an encoder's is not), where the
reference picks its jnp ``mha_dense`` or ``mha_chunked`` by length; those
compute the same function and are not ported.  Cross attention at prefill
runs the same operator unmasked, with the prompt's queries against the
encoder's keys (Sq != Sk).  Decode runs the reference's dense ``_sdpa``
step, against the self cache with its mask and against the cross cache
with none.
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
The cross cache ``enc_kv`` is head-major too, {"k", "v"} [B, KV, enc_seq,
hd], where the reference's is a (k, v) pair of [B, enc_seq, KV, hd].
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from .layers import NOT_PORTED, dtype_of, normal, rmsnorm
from .rope import apply_rope


def check_spec(spec: LayerSpec) -> None:
    if spec.attn not in ("full", "window", "hybrid"):
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


def init_cross_attention(generator: torch.Generator, cfg: ModelConfig,
                         dtype: torch.dtype | None = None):
    """A decoder layer's cross attention: a full attention layer's weights."""
    return init_attention(generator, cfg, LayerSpec(), dtype)


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


def _heads(x, w):
    """x [B,S,D] @ w [D,n,hd] -> [B,S,n,hd], contiguous."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1).to(x.dtype)).view(B, S, *w.shape[1:])


def _project(p, x, cfg: ModelConfig, angles):
    """x [B,S,D] -> q [B,S,H,hd], k and v [B,S,KV,hd], contiguous, qk-normed and rotated."""
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
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
def apply_attention(p, x, cfg: ModelConfig, spec: LayerSpec, angles, causal: bool = True):
    """Full-sequence attention for training, or an encoder's (``causal=False``):
    x [B,S,D] -> [B,S,D].  The reference's ``mha_dense``/``mha_chunked``
    become the flash kernel at every S, with the layer's window, through
    ``ops.flash_mha``.  It is differentiable when causal, with the layer's
    window or without one, and unmasked (an encoder's) without a window, at
    head dims up to 128 and without a softcap; asking for the gradient of
    any other (gemma's head dim 256 and softcap) raises NotImplementedError
    (``check_bwd_supported``) until its backward lands (ROADMAP B2d)."""
    check_spec(spec)
    q, k, v = _project(p, x, cfg, angles)
    out = ops.flash_mha(q, k, v, causal=causal, window=_window(spec), softcap=cfg.attn_softcap,
                        scale=_scale(cfg))
    return _out(p, out, cfg)


def encode_cross_kv(p, enc_out, cfg: ModelConfig):
    """The encoder's output [B,Se,D] -> cross k, v [B,Se,KV,hd], contiguous
    (position-major, as the flash operator takes them and the reference
    returns them)."""
    return _heads(enc_out, p["wk"]), _heads(enc_out, p["wv"])


def apply_cross_attention(p, x, enc_kv, cfg: ModelConfig):
    """Cross attention over the whole prompt: x [B,S,D] against ``enc_kv`` =
    (k, v) from ``encode_cross_kv``, unmasked, through ``ops.flash_mha``
    (the reference's ``_sdpa`` with no mask computes the same function).
    Differentiable in x and in k, v (so in the encoder's output), at any S
    and Se: the flash gradient takes unmasked attention with Sq != Sk."""
    k, v = enc_kv
    out = ops.flash_mha(_heads(x, p["wq"]), k, v, causal=False, softcap=cfg.attn_softcap,
                        scale=_scale(cfg))
    return _out(p, out, cfg)


def cross_cache(enc_kv):
    """(k, v) [B,Se,KV,hd] -> the head-major cross cache {"k", "v"} [B,KV,Se,hd]."""
    k, v = enc_kv
    return {"k": k.transpose(1, 2).contiguous(), "v": v.transpose(1, 2).contiguous()}


def decode_cross_attention(p, x, cache, cfg: ModelConfig):
    """One token's cross attention: x [B,1,D] against the head-major cross
    cache, with no mask, as the reference's decode runs ``_sdpa``."""
    return _out(p, _sdpa(_heads(x, p["wq"]), cache["k"], cache["v"], None, cfg), cfg)


# ------------------------------------------------------------------ cache
def cache_len(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> int:
    """Slots of the layer's ring: min(max_seq, window) for a layer with a
    window, else max_seq."""
    check_spec(spec)
    window = _window(spec)
    return max_seq if window is None else min(max_seq, window)


def prefill_attention(p, x, cfg: ModelConfig, spec: LayerSpec, angles, max_seq: int,
                      causal: bool = True):
    """Full-sequence attention (causal by default) that also emits the filled
    KV cache.  The ring's slots are written with tensor indices, so nothing
    here reads a value back to the host (``serve --plan`` traces it on fake
    tensors)."""
    B, S, _ = x.shape
    q, k, v = _project(p, x, cfg, angles)
    out = ops.flash_mha(q, k, v, causal=causal, window=_window(spec), softcap=cfg.attn_softcap,
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
