"""Decoder-only LM: the training loss, and serving (prefill into a decode
cache, then decode steps).

Counterpart of ``repro/models/transformer.py``, for full-attention,
sliding-window, MLA, Mamba-2 and hybrid mixers, each with a dense FFN
(SwiGLU or GELU), an MoE FFN or none, under RMSNorm or LayerNorm; other
layer kinds, and config fields the port does not implement, raise
NotImplementedError naming the ROADMAP item.  Each layer dispatches on its
kind as the reference's does: ln1, then the mixer, then the residual, then,
in an encoder-decoder's decoder layer, ``ln_cross`` and cross attention
over the encoder's output with its residual, then ``ln2`` and the FFN
where the layer has one.  With ``cfg.sandwich_norms`` (gemma2, gemma3) the
mixer's output is normed by ``ln1_post`` and the FFN's by ``ln2_post``
before their residuals, where the reference norms them: ``ln2_post`` in
every layer function, ``ln1_post`` after any mixer when training but, in
prefill and decode, after full or window attention only (never after MLA,
Mamba-2 or the hybrid mixer), as the reference's ``prefill_layer`` and
``decode_layer`` do.  With ``cfg.scale_embed`` the token embeddings are
multiplied by sqrt(d_model) rounded to their dtype first (``embed_scale``).
With ``cfg.mrope_sections`` (qwen2-vl) the rotary angles are M-RoPE's,
each section of the spectrum taken from its channel of the [3, B, S]
(t/h/w) positions; with ``cfg.frontend="vision_stub"`` the batch's patch
embeddings come before the text's, as the reference's ``_embed_inputs``
puts them, and the loss pads the labels with -1 over them.
``models/encdec.py`` runs these layers as
whisper's encoder (``causal=False``) and decoder.  A hybrid
layer (hymba) runs attention and a Mamba-2 mixer on the same normed input
and adds ``0.5 * (rmsnorm(a) + rmsnorm(m))``, each branch normed by its own
fp32 scale, in the activations' dtype.
The reference scans stacked segment parameters with ``lax.scan``; here
``params["blocks"]`` and the cache hold one entry per layer, in program
order, and a Python loop runs them (``models/convert.py`` unstacks a JAX
pytree into this form).  ``Model.loss`` trains attention (full, or MLA's)
and Mamba-2 mixers, with dense or MoE FFNs or none; each MoE layer's
Switch aux loss is carried out of the layer (through remat and an offload
policy alike) and summed in fp32, and the loss is ``ce + 0.01 * aux``, as
the reference's.  Hybrid layers train too: their attention branch takes
the flash gradient with the layer's window (29 of hymba's 32 layers have
one) beside the SSD scan's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig, Segment
from repro_torch.kernels.ops import label
from repro_torch.tree import tree_leaves
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (
    NOT_PORTED,
    ShapeOnly,
    apply_dense_ffn,
    apply_norm,
    chunked_softmax_xent,
    dtype_of,
    embed_tokens,
    init_dense_ffn,
    init_embedding,
    init_norm,
    lm_logits,
    rmsnorm,
)
from .rope import mrope_angles, position_tensor, rope_angles


# The weight of the summed MoE aux loss in the training loss: the
# reference's ``ce + 0.01 * aux`` (``repro/models/transformer.py:447``).
AUX_WEIGHT = 0.01


def _check_spec(spec: LayerSpec) -> None:
    if spec.ffn not in ("dense", "moe", "none"):
        raise NotImplementedError(f"ffn {spec.ffn!r} {NOT_PORTED}")
    if spec.attn not in ("mamba", "mla"):
        attn_mod.check_spec(spec)


def layer_specs(program: tuple[Segment, ...]) -> list[LayerSpec]:
    """One LayerSpec per layer, in execution order."""
    return [spec for unit, reps in program for _ in range(reps) for spec in unit]


def check_config(cfg: ModelConfig, program: tuple[Segment, ...],
                 frontend: str | None = None, mrope: bool = False) -> None:
    """Raise NotImplementedError on a config field or a layer of ``program``
    that the caller does not compute, rather than serve another function:
    ``frontend`` names the one frontend the caller consumes (the vision
    stub's patches ``Model``'s, the audio stub's frames ``EncDecModel``'s),
    ``mrope`` says whether it computes M-RoPE (``EncDecModel``'s sinusoids
    take no rotary angles)."""
    if cfg.mrope_sections and not mrope:
        raise NotImplementedError(f"{cfg.name}: mrope_sections={cfg.mrope_sections!r} "
                                  f"{NOT_PORTED}")
    if cfg.frontend and cfg.frontend != frontend:
        raise NotImplementedError(f"{cfg.name}: frontend={cfg.frontend!r} {NOT_PORTED}")
    for spec in layer_specs(program):
        _check_spec(spec)


# ---------------------------------------------------------------- layers
def init_layer(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype: torch.dtype):
    _check_spec(spec)
    dev = generator.device
    p: dict[str, Any] = {"ln1": init_norm(cfg, dev)}
    if spec.attn == "mamba":
        p["mamba"] = ssm_mod.init_mamba(generator, cfg, dtype)
    elif spec.attn == "mla":
        p["attn"] = mla_mod.init_mla(generator, cfg, spec, dtype)
    else:
        p["attn"] = attn_mod.init_attention(generator, cfg, spec, dtype)
    if spec.attn == "hybrid":
        p["mamba"] = ssm_mod.init_mamba(generator, cfg, dtype)
        p["branch_norm_a"] = torch.ones(cfg.d_model, dtype=torch.float32, device=dev)
        p["branch_norm_m"] = torch.ones(cfg.d_model, dtype=torch.float32, device=dev)
    if cfg.sandwich_norms:
        p["ln1_post"] = init_norm(cfg, dev)
    if spec.cross_attn:
        p["ln_cross"] = init_norm(cfg, dev)
        p["cross"] = attn_mod.init_cross_attention(generator, cfg, dtype)
    if spec.ffn != "none":
        p["ln2"] = init_norm(cfg, dev)
    if spec.ffn == "dense":
        p["ffn"] = init_dense_ffn(generator, cfg, dtype)
    elif spec.ffn == "moe":
        p["moe"] = moe_mod.init_moe(generator, cfg, dtype)
    if spec.ffn != "none" and cfg.sandwich_norms:
        p["ln2_post"] = init_norm(cfg, dev)
    return p


def _post_norm(p, name: str, h, cfg: ModelConfig):
    """A sandwich norm ``name`` (``ln1_post``, ``ln2_post``) of a sublayer's
    output, where the config has them."""
    return apply_norm(p[name], h, cfg) if cfg.sandwich_norms else h


def _ffn_aux(p, x, cfg: ModelConfig, spec: LayerSpec):
    """The FFN sublayer, its sandwich norm and its residual -> (x, aux): the
    MoE's fp32 aux loss, or None for a layer without one (the reference's
    zero, which adds nothing)."""
    if spec.ffn == "none":
        return x, None
    h = apply_norm(p["ln2"], x, cfg)
    aux = None
    if spec.ffn == "dense":
        h = apply_dense_ffn(p["ffn"], h, cfg)
    else:
        h, aux = moe_mod.apply_moe(p["moe"], h, cfg)
    return x + _post_norm(p, "ln2_post", label(h, "ffn_out"), cfg), aux


def _ffn(p, x, cfg: ModelConfig, spec: LayerSpec):
    """``_ffn_aux``'s output alone: serving drops the MoE's aux loss."""
    return _ffn_aux(p, x, cfg, spec)[0]


def _cross(p, x, cfg: ModelConfig, enc_kv):
    """The cross-attention sublayer and its residual over the whole prompt:
    ``enc_kv`` is ``attention.encode_cross_kv``'s (k, v)."""
    h = apply_norm(p["ln_cross"], x, cfg)
    return x + attn_mod.apply_cross_attention(p["cross"], h, enc_kv, cfg)


def train_layer(p, x, cfg: ModelConfig, spec: LayerSpec, angles, enc_out=None,
                causal: bool = True):
    """Forward one attention, MLA, Mamba-2 or hybrid layer over the whole
    sequence, for the loss or as an encoder layer (``causal=False``) -> (x,
    aux), as the reference's ``apply_layer``: ``aux`` is the MoE FFN's fp32
    aux loss, or None for a layer without one.  A hybrid layer's mixer is
    the reference's ``_mix`` (``repro/models/transformer.py:88-94``): the
    attention branch with the layer's window and the Mamba-2 branch on the
    same normed input, merged by ``_merge_branches``.  The reference's
    activation labels (``block_in``, ``attn_out`` after the mixer, a hybrid
    layer's merge included, ``ffn_out``:
    ``repro/models/transformer.py:106,118,319``) name variables for the
    planner and, under an offload policy, the activations it offloads or
    saves; otherwise they cost nothing on real tensors.  A decoder layer
    with cross attention reads the encoder's output ``enc_out``."""
    x = label(x, "block_in")
    h = apply_norm(p["ln1"], x, cfg)
    if spec.attn == "mamba":
        h = ssm_mod.apply_mamba(p["mamba"], h, cfg)
    elif spec.attn == "mla":
        h = mla_mod.apply_mla(p["attn"], h, cfg, spec, angles, causal=causal)
    elif spec.attn == "hybrid":
        a = attn_mod.apply_attention(p["attn"], h, cfg, spec, angles, causal)
        h = _merge_branches(p, a, ssm_mod.apply_mamba(p["mamba"], h, cfg), cfg)
    else:
        h = attn_mod.apply_attention(p["attn"], h, cfg, spec, angles, causal)
    x = x + _post_norm(p, "ln1_post", label(h, "attn_out"), cfg)
    if spec.cross_attn:
        x = _cross(p, x, cfg, attn_mod.encode_cross_kv(p["cross"], enc_out, cfg))
    return _ffn_aux(p, x, cfg, spec)


def _merge_branches(p, a, m, cfg: ModelConfig):
    """A hybrid layer's mixer output from its attention branch ``a`` and its
    Mamba-2 branch ``m``, in the reference's order and dtype."""
    return 0.5 * (rmsnorm(p["branch_norm_a"], a, cfg.norm_eps)
                  + rmsnorm(p["branch_norm_m"], m, cfg.norm_eps))


def prefill_layer(p, x, cfg: ModelConfig, spec: LayerSpec, angles, max_seq: int,
                  enc_out=None, causal: bool = True):
    """Forward one layer over the whole prompt, emitting its decode cache: a
    decoder layer with cross attention also emits its head-major cross
    K/V over the encoder's output ``enc_out`` as ``"enc_kv"``."""
    cache: dict[str, Any] = {}
    h = apply_norm(p["ln1"], x, cfg)
    if spec.attn == "mamba":
        h, cache["ssm"] = ssm_mod.apply_mamba(p["mamba"], h, cfg, return_cache=True)
    elif spec.attn == "mla":
        h, cache["kv"] = mla_mod.prefill_mla(p["attn"], h, cfg, spec, angles, max_seq)
    elif spec.attn == "hybrid":
        a, cache["kv"] = attn_mod.prefill_attention(p["attn"], h, cfg, spec, angles, max_seq)
        m, cache["ssm"] = ssm_mod.apply_mamba(p["mamba"], h, cfg, return_cache=True)
        h = _merge_branches(p, a, m, cfg)
    else:
        h, cache["kv"] = attn_mod.prefill_attention(p["attn"], h, cfg, spec, angles, max_seq,
                                                    causal)
        h = _post_norm(p, "ln1_post", h, cfg)
    x = x + h
    if spec.cross_attn:
        enc_kv = attn_mod.encode_cross_kv(p["cross"], enc_out, cfg)
        cache["enc_kv"] = attn_mod.cross_cache(enc_kv)
        x = _cross(p, x, cfg, enc_kv)
    return _ffn(p, x, cfg, spec), cache


def decode_layer(p, x, cache, pos: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, angles):
    """One token through one layer; updates ``cache`` in place and returns it.
    ``pos`` is a 0-d integer tensor on x's device."""
    h = apply_norm(p["ln1"], x, cfg)
    if spec.attn == "mamba":
        h, cache["ssm"] = ssm_mod.decode_mamba(p["mamba"], h, cache["ssm"], cfg)
    elif spec.attn == "mla":
        h, cache["kv"] = mla_mod.decode_mla(p["attn"], h, cache["kv"], pos, cfg, spec, angles)
    elif spec.attn == "hybrid":
        a, cache["kv"] = attn_mod.decode_attention(p["attn"], h, cache["kv"], pos, cfg, spec,
                                                   angles)
        m, cache["ssm"] = ssm_mod.decode_mamba(p["mamba"], h, cache["ssm"], cfg)
        h = _merge_branches(p, a, m, cfg)
    else:
        h, cache["kv"] = attn_mod.decode_attention(p["attn"], h, cache["kv"], pos, cfg, spec,
                                                   angles)
        h = _post_norm(p, "ln1_post", h, cfg)
    x = x + h
    if spec.cross_attn:
        h = apply_norm(p["ln_cross"], x, cfg)
        x = x + attn_mod.decode_cross_attention(p["cross"], h, cache["enc_kv"], cfg)
    return _ffn(p, x, cfg, spec), cache


def embed_scale(cfg: ModelConfig) -> float:
    """sqrt(d_model) rounded to the activations' dtype, as the reference's
    ``jnp.asarray(cfg.d_model**0.5, x.dtype)`` (``repro/models/
    transformer.py:420, 475``): in bf16 sqrt(2560) is 50.5 and sqrt(3584)
    59.75.  That value is exact in fp32, so ``x * embed_scale(cfg)``, which
    PyTorch computes in fp32 and rounds once, gives the reference's product
    of two bf16 values bit for bit, where ``x * d**0.5`` would multiply by
    the unrounded root."""
    return torch.tensor(cfg.d_model**0.5, dtype=dtype_of(cfg)).item()


def init_program_cache(cfg: ModelConfig, program, batch: int, max_seq: int, dtype, device):
    """One zeroed cache per layer, in execution order: {"kv": {"k", "v"}} for
    attention (a ring of ``attention.cache_len`` slots), {"kv": {"c_kv",
    "k_rope"}} for MLA, {"ssm": {"state", "conv"}} for Mamba-2, and both
    "kv" and "ssm" for a hybrid layer; a layer with cross attention also
    holds "enc_kv": {"k", "v"} [B, KV, enc_seq, hd]."""
    def layer_cache(spec):
        if spec.attn == "mamba":
            return {"ssm": ssm_mod.init_mamba_cache(cfg, batch, dtype, device)}
        if spec.attn == "mla":
            return {"kv": mla_mod.init_mla_cache(cfg, batch, max_seq, dtype, device)}
        c = {"kv": attn_mod.init_kv_cache(cfg, spec, batch, max_seq, dtype, device)}
        if spec.attn == "hybrid":
            c["ssm"] = ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
        if spec.cross_attn:
            c["enc_kv"] = attn_mod.init_kv_cache(cfg, LayerSpec(), batch, cfg.enc_seq, dtype,
                                                 device)
        return c

    return [layer_cache(spec) for spec in layer_specs(program)]


# ------------------------------------------------------------------ model
@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def __post_init__(self):
        self.device = torch.device(self.device)
        check_config(self.cfg, self.cfg.program, frontend="vision_stub", mrope=True)
        if any(spec.cross_attn for spec in layer_specs(self.cfg.program)):
            raise ValueError(f"{self.cfg.name}: cross-attention layers read an encoder's "
                             f"output; build an encoder-decoder (models.build_model)")

    # ---- parameters ----
    def init(self, generator: torch.Generator, dtype: torch.dtype | None = None):
        """Random parameters from ``generator``, which must live on
        ``self.device``.  Matrices are stored as ``dtype``: ``cfg.dtype``
        when None (serving), ``torch.float32`` for training's masters."""
        if generator.device.type not in (self.device.type, "meta"):
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg = self.cfg
        specs = layer_specs(cfg.program)
        dtype = dtype or dtype_of(cfg)
        return {
            "embed": init_embedding(generator, cfg, dtype),
            "blocks": [init_layer(generator, cfg, spec, dtype) for spec in specs],
            "final_norm": init_norm(cfg, generator.device),
        }

    def init_shapes(self, dtype: torch.dtype | None = None):
        """``init``'s parameters as meta tensors: shapes and dtypes, no memory
        and no random draw (the counterpart of the reference's
        ``jax.eval_shape(self.init, ...)``), for tracing a step."""
        return self.init(ShapeOnly(), dtype)

    def _embed(self, params, tokens, patches=None):
        """Token embeddings in the activations' dtype, after the vision
        stub's ``patches`` [B, npatch, D] where given (cast to that dtype),
        all scaled by ``embed_scale`` where the config says so, as the
        reference's ``_embed_inputs`` (``repro/models/transformer.py:
        413-421``)."""
        x = embed_tokens(params["embed"], tokens, self.cfg)
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x * embed_scale(self.cfg) if self.cfg.scale_embed else x

    def _patches(self, batch):
        """The batch's patch embeddings where the config's vision stub reads
        them, else None."""
        return batch.get("patch_embeds") if self.cfg.frontend == "vision_stub" else None

    def _embed_inputs(self, params, batch):
        """tokens (+ the vision stub's patch embeddings) -> (x [B, S, D],
        positions): the batch's ``positions`` ([3, B, S] for M-RoPE) where
        it has them, else the arange over the whole sequence, [B, S], or in
        all three channels for M-RoPE as ``decode_step`` puts its position
        (the reference's [B, S] would index the batch as the channels)."""
        x = self._embed(params, batch["tokens"], self._patches(batch))
        positions = batch.get("positions")
        if positions is None:
            shape = x.shape[:2] if self.cfg.mrope_sections is None else (3, *x.shape[:2])
            positions = torch.arange(x.shape[1], device=x.device).expand(shape)
        return x, positions

    def _angles(self, positions):
        """RoPE angles at the rotated head dim: MLA's qk_rope, else head_dim;
        M-RoPE's from [3, ...] positions where the config has sections."""
        cfg = self.cfg
        if cfg.num_heads == 0:  # attention-free (mamba2)
            return None
        hd = cfg.qk_rope_head_dim if cfg.kv_lora_rank else cfg.head_dim
        if cfg.mrope_sections is not None:
            return mrope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
        return rope_angles(positions, hd, cfg.rope_theta)

    # ---- training ----
    def loss(self, params, batch, remat: bool = True, remat_policy=None):
        """Mean next-token CE of ``batch`` {"tokens", "labels"} [B, S] int
        (with a vision stub's "patch_embeds" and "positions", as prefill
        takes them) plus ``AUX_WEIGHT`` times the MoE layers' aux losses,
        summed in fp32 in layer order -> (loss, {"ce", "aux"}), as the
        reference's; a model without MoE layers has aux 0 and its loss is
        the CE itself (the reference's ``ce + 0.01 * 0``).  The labels are
        padded with -1, which the loss ignores, over the patches, as the
        reference's (``repro/models/transformer.py:440-444``).  As the reference's,
        position i is scored against labels[i + 1], and the data's labels
        are already the tokens shifted by one, so position i learns token
        i + 2 (ROADMAP queue C).  ``remat`` recomputes each layer in backward
        (``torch.utils.checkpoint``), so only its input is kept.  With
        ``remat``, a ``remat_policy`` (``OffloadPlan.policy()``, an
        ``OffloadPolicy``) runs each layer instead, offloading and saving
        the labelled activations it names; without ``remat`` it is ignored,
        as the reference's is."""
        cfg = self.cfg
        specs = layer_specs(cfg.program)
        x, positions = self._embed_inputs(params, batch)
        angles = self._angles(positions)
        aux = None
        for p, spec in zip(params["blocks"], specs):
            if remat and remat_policy is not None:
                x, a = remat_policy.run_layer(partial(train_layer, p, cfg=cfg, spec=spec,
                                                      angles=angles), x, tree_leaves(p))
            elif remat:  # no layer draws random numbers, so no RNG state is saved
                x, a = checkpoint(train_layer, p, x, cfg, spec, angles, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = train_layer(p, x, cfg, spec, angles)
            if a is not None:
                aux = a if aux is None else aux + a
        x = apply_norm(params["final_norm"], x, cfg)
        labels = batch["labels"]
        patches = self._patches(batch)
        if patches is not None:
            labels = torch.cat([labels.new_full((labels.shape[0], patches.shape[1]), -1),
                                labels], dim=1)
        ce = chunked_softmax_xent(x[:, :-1], params["embed"], labels[:, 1:], cfg)
        if aux is None:  # no MoE layer: the reference's ce + 0.01 * 0 is ce
            return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}
        return ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux}

    # ---- serving ----
    def init_cache(self, batch: int, max_seq: int):
        return init_program_cache(
            self.cfg, self.cfg.program, batch, max_seq, dtype_of(self.cfg), self.device
        )

    def prefill(self, params, batch, max_seq: int | None = None):
        """Forward the prompt (the vision stub's patches first, where the
        batch has them), return (last-position logits [B,1,V], filled
        cache)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        angles = self._angles(positions)
        max_seq = max_seq or x.shape[1]
        cache = []
        for p, spec in zip(params["blocks"], layer_specs(cfg.program)):
            x, c = prefill_layer(p, x, cfg, spec, angles, max_seq)
            cache.append(c)
        # The norm is row-wise: norming the last position alone equals the
        # reference's norm of all positions followed by the slice.
        x = apply_norm(params["final_norm"], x[:, -1:].contiguous(), cfg)
        return lm_logits(params["embed"], x, cfg), cache

    def decode_step(self, params, cache, tokens, pos):
        """tokens [B,1] int, pos a 0-d integer tensor (or an int, made one on
        tokens' device) -> (logits [B,1,V], cache updated in place).  Nothing
        reads ``pos`` on the host, so a step costs no sync and traces once
        for every position, as the reference's does with an int32 scalar.
        For M-RoPE the one position stands in all three channels ([3, B,
        1]), as the reference's (``repro/models/transformer.py:479-481``)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        pos = position_tensor(pos, tokens.device)
        shape = tokens.shape if cfg.mrope_sections is None else (3, *tokens.shape)
        angles = self._angles(pos.expand(shape))
        for p, c, spec in zip(params["blocks"], cache, layer_specs(cfg.program)):
            x, _ = decode_layer(p, x, c, pos, cfg, spec, angles)
        x = apply_norm(params["final_norm"], x, cfg)
        return lm_logits(params["embed"], x, cfg), cache
