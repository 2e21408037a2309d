"""Decoder-only LM: the training loss, and serving (prefill into a decode
cache, then decode steps).

Counterpart of ``repro/models/transformer.py``, for full-attention and Mamba-2
mixers, each with a dense FFN or none; other layer kinds raise
NotImplementedError naming the ROADMAP item.  Each layer dispatches on its
kind as the reference's does: ln1, then the mixer, then the residual, then
``ln2`` and the FFN where the layer has one.
The reference scans stacked segment parameters with ``lax.scan``; here
``params["blocks"]`` and the cache hold one entry per layer, in program
order, and a Python loop runs them (``models/convert.py`` unstacks a JAX
pytree into this form).  ``Model.loss`` trains attention layers only:
Mamba-2 training waits for the SSD scan's gradient (ROADMAP queue B item 3).
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
)
from .rope import position_tensor, rope_angles


NOT_TRAINED = ("is not yet ported: it needs the SSD scan's gradient, see ROADMAP.md queue B "
               "item 3")


def _check_spec(spec: LayerSpec) -> None:
    if spec.ffn not in ("dense", "none"):
        raise NotImplementedError(f"ffn {spec.ffn!r} {NOT_PORTED}")
    if spec.attn != "mamba":
        attn_mod.check_spec(spec)


def layer_specs(program: tuple[Segment, ...]) -> list[LayerSpec]:
    """One LayerSpec per layer, in execution order."""
    return [spec for unit, reps in program for _ in range(reps) for spec in unit]


# ---------------------------------------------------------------- layers
def init_layer(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype: torch.dtype):
    _check_spec(spec)
    dev = generator.device
    p: dict[str, Any] = {"ln1": init_norm(cfg, dev)}
    if spec.attn == "mamba":
        p["mamba"] = ssm_mod.init_mamba(generator, cfg)
    else:
        p["attn"] = attn_mod.init_attention(generator, cfg, spec, dtype)
    if spec.ffn == "dense":
        p["ln2"] = init_norm(cfg, dev)
        p["ffn"] = init_dense_ffn(generator, cfg, dtype)
    return p


def _ffn(p, x, cfg: ModelConfig, spec: LayerSpec):
    if spec.ffn == "dense":
        h = apply_dense_ffn(p["ffn"], apply_norm(p["ln2"], x, cfg), cfg)
        x = x + label(h, "ffn_out")
    return x


def train_layer(p, x, cfg: ModelConfig, spec: LayerSpec, angles):
    """Forward one attention layer over the whole sequence, for the loss,
    with the reference's activation labels (``block_in``, ``attn_out``,
    ``ffn_out``: ``repro/models/transformer.py:106,118,319``), which name
    variables for the planner and, under an offload policy, the
    activations it offloads or saves; otherwise they cost nothing on real
    tensors."""
    x = label(x, "block_in")
    h = attn_mod.apply_attention(p["attn"], apply_norm(p["ln1"], x, cfg), cfg, spec, angles)
    return _ffn(p, x + label(h, "attn_out"), cfg, spec)


def prefill_layer(p, x, cfg: ModelConfig, spec: LayerSpec, angles, max_seq: int):
    """Forward one layer over the whole prompt, emitting its decode cache."""
    cache: dict[str, Any] = {}
    h = apply_norm(p["ln1"], x, cfg)
    if spec.attn == "mamba":
        h, cache["ssm"] = ssm_mod.apply_mamba(p["mamba"], h, cfg, return_cache=True)
    else:
        h, cache["kv"] = attn_mod.prefill_attention(p["attn"], h, cfg, spec, angles, max_seq)
    return _ffn(p, x + h, cfg, spec), cache


def decode_layer(p, x, cache, pos: torch.Tensor, cfg: ModelConfig, spec: LayerSpec, angles):
    """One token through one layer; updates ``cache`` in place and returns it.
    ``pos`` is a 0-d integer tensor on x's device."""
    h = apply_norm(p["ln1"], x, cfg)
    if spec.attn == "mamba":
        h, cache["ssm"] = ssm_mod.decode_mamba(p["mamba"], h, cache["ssm"], cfg)
    else:
        h, cache["kv"] = attn_mod.decode_attention(p["attn"], h, cache["kv"], pos, cfg, spec,
                                                   angles)
    return _ffn(p, x + h, cfg, spec), cache


def init_program_cache(cfg: ModelConfig, program, batch: int, max_seq: int, dtype, device):
    """One zeroed cache per layer, in execution order: {"kv": {"k", "v"}} for
    attention, {"ssm": {"state", "conv"}} for Mamba-2."""
    return [
        {"ssm": ssm_mod.init_mamba_cache(cfg, batch, dtype, device)} if spec.attn == "mamba"
        else {"kv": attn_mod.init_kv_cache(cfg, spec, batch, max_seq, dtype, device)}
        for spec in layer_specs(program)
    ]


# ------------------------------------------------------------------ model
@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def __post_init__(self):
        self.device = torch.device(self.device)
        for spec in layer_specs(self.cfg.program):
            _check_spec(spec)

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
        if dtype != dtype_of(cfg) and any(spec.attn == "mamba" for spec in specs):
            raise NotImplementedError(f"Mamba-2 weights stored apart from cfg.dtype (training) "
                                      f"{NOT_TRAINED}")
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

    def _angles(self, positions):
        if self.cfg.num_heads == 0:  # attention-free (mamba2)
            return None
        return rope_angles(positions, self.cfg.head_dim, self.cfg.rope_theta)

    # ---- training ----
    def loss(self, params, batch, remat: bool = True, remat_policy=None):
        """Mean next-token CE of ``batch`` {"tokens", "labels"} [B, S] int ->
        (loss, {"ce", "aux"}).  As the reference's, position i is scored
        against labels[i + 1], and the data's labels are already the tokens
        shifted by one, so position i learns token i + 2 (ROADMAP queue C).
        ``remat`` recomputes each layer in backward
        (``torch.utils.checkpoint``), so only its input is kept.  With
        ``remat``, a ``remat_policy`` (``OffloadPlan.policy()``, an
        ``OffloadPolicy``) runs each layer instead, offloading and saving
        the labelled activations it names; without ``remat`` it is ignored,
        as the reference's is."""
        cfg = self.cfg
        specs = layer_specs(cfg.program)
        if any(spec.attn == "mamba" for spec in specs):
            raise NotImplementedError(f"Mamba-2 training {NOT_TRAINED}")
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
        B, S = tokens.shape
        angles = self._angles(torch.arange(S, device=tokens.device).expand(B, S))
        for p, spec in zip(params["blocks"], specs):
            if remat and remat_policy is not None:
                x = remat_policy.run_layer(partial(train_layer, p, cfg=cfg, spec=spec,
                                                   angles=angles), x, tree_leaves(p))
            elif remat:  # no layer draws random numbers, so no RNG state is saved
                x = checkpoint(train_layer, p, x, cfg, spec, angles, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = train_layer(p, x, cfg, spec, angles)
        x = apply_norm(params["final_norm"], x, cfg)
        ce = chunked_softmax_xent(x[:, :-1], params["embed"], batch["labels"][:, 1:], cfg)
        # The dense family has no auxiliary loss: the reference's ce + 0.01 * 0.
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    # ---- serving ----
    def init_cache(self, batch: int, max_seq: int):
        return init_program_cache(
            self.cfg, self.cfg.program, batch, max_seq, dtype_of(self.cfg), self.device
        )

    def prefill(self, params, batch, max_seq: int | None = None):
        """Forward the prompt, return (last-position logits [B,1,V], filled cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        angles = self._angles(positions)
        max_seq = max_seq or S
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
        for every position, as the reference's does with an int32 scalar."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        pos = position_tensor(pos, tokens.device)
        angles = self._angles(pos.expand(tokens.shape))
        for p, c, spec in zip(params["blocks"], cache, layer_specs(cfg.program)):
            x, _ = decode_layer(p, x, c, pos, cfg, spec, angles)
        x = apply_norm(params["final_norm"], x, cfg)
        return lm_logits(params["embed"], x, cfg), cache
