"""Encoder-decoder LM (whisper-large-v3's backbone): training and serving.

Counterpart of ``repro/models/encdec.py``.  The audio frontend is the
reference's stub: the batch carries post-conv frame embeddings
``"frames"`` [B, enc_seq, d_model] beside the decoder's ``"tokens"``.  Both
stacks add sinusoidal positions (``sinusoid``), as the reference does.  The
encoder runs its layers unmasked (``transformer.train_layer`` with
``causal=False``: the flash operator with no mask, at Sq = Sk = enc_seq);
each decoder layer runs causal self-attention, then cross attention over
the encoder's output (the flash operator unmasked with the prompt's
queries against enc_seq keys at prefill, the dense ``_sdpa`` step at
decode), then its FFN.  Prefill returns, for each decoder layer, its self
K/V cache and its cross K/V ``"enc_kv"``, computed once from the encoder's
output; decode reads both.

As ``transformer.Model``, the layers are a Python loop over one parameter
dict and one cache dict per layer (``models/convert.py`` unstacks a JAX
pytree into this form), the cache is updated in place, and ``pos`` is a
0-d tensor on the device that nothing reads on the host.

``loss`` is the reference's (``repro/models/encdec.py:83-94``): the encoder
runs without remat, as the reference's ``apply_program`` does by default,
so its activations are kept; each decoder layer runs under per-layer remat
(``checkpoint``), or through an offload policy's ``run_layer``, as the
reference passes ``remat`` and ``remat_policy`` to the decoder only.  The
encoder's gradient is the sum of the 32 cross attentions' gradients of its
output: the flash gradient of unmasked attention with Sq != Sk, beside the
encoder's own unmasked self attention at Sq = Sk = enc_seq.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import tree_leaves
from .layers import (
    ShapeOnly,
    apply_norm,
    chunked_softmax_xent,
    dtype_of,
    embed_tokens,
    init_embedding,
    init_norm,
    lm_logits,
)
from .rope import position_tensor
from .transformer import (
    check_config,
    decode_layer,
    init_layer,
    init_program_cache,
    layer_specs,
    prefill_layer,
    train_layer,
)

def sinusoid(pos0: int, seq: int, d: int, dtype, device=None) -> torch.Tensor:
    """The sinusoid rows of positions [pos0, pos0 + seq): [seq, d], each row
    ``[sin(ang) | cos(ang)]`` with ang = pos / 10000^(2i/d), i < d/2, built in
    float64 and cast to ``dtype``, as the reference's table (a numpy float64
    table) is; the reference slices rows pos0 on of a table from 0."""
    pos = torch.arange(pos0, pos0 + seq, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64, device=device)[None, :]
    ang = pos / 10000 ** (2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def sinusoid_row(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """Decode's position row [d] at the 0-d tensor ``pos``, in fp32 on its
    device, as the reference computes it at decode
    (``repro/models/encdec.py:114-118``), cast to ``dtype``."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float() / 10000 ** (2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)


@dataclass
class EncDecModel:
    cfg: ModelConfig
    device: torch.device

    def __post_init__(self):
        self.device = torch.device(self.device)
        check_config(self.cfg, self.cfg.enc_program + self.cfg.program, frontend="audio_stub")
        if any(spec.cross_attn for spec in layer_specs(self.cfg.enc_program)):
            raise ValueError(f"{self.cfg.name}: an encoder layer has cross attention")

    # ---- parameters ----
    def init(self, generator: torch.Generator, dtype: torch.dtype | None = None):
        """Random parameters from ``generator`` on ``self.device``: the
        reference's tree, ``embed``, ``encoder`` and ``decoder`` (one dict a
        layer), ``enc_norm`` and ``final_norm``; matrices stored as ``dtype``
        (``cfg.dtype`` when None), norms and biases fp32."""
        if generator.device.type not in (self.device.type, "meta"):
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg = self.cfg
        dtype = dtype or dtype_of(cfg)

        def stack(program):
            return [init_layer(generator, cfg, spec, dtype) for spec in layer_specs(program)]

        return {
            "embed": init_embedding(generator, cfg, dtype),
            "encoder": stack(cfg.enc_program),
            "enc_norm": init_norm(cfg, generator.device),
            "decoder": stack(cfg.program),
            "final_norm": init_norm(cfg, generator.device),
        }

    def init_shapes(self, dtype: torch.dtype | None = None):
        """``init``'s parameters as meta tensors (no memory, no draw)."""
        return self.init(ShapeOnly(), dtype)

    # ---- the two stacks ----
    def encode(self, params, frames):
        """frames [B, enc_seq, D] (the stub frontend's output) -> the
        encoder's normed output [B, enc_seq, D] in the activation dtype."""
        cfg = self.cfg
        x = frames.to(dtype_of(cfg))
        x = x + sinusoid(0, x.shape[1], cfg.d_model, x.dtype, x.device)[None]
        for p, spec in zip(params["encoder"], layer_specs(cfg.enc_program)):
            x, _ = train_layer(p, x, cfg, spec, None, causal=False)
        return apply_norm(params["enc_norm"], x, cfg)

    def _embed_dec(self, params, tokens):
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        return x + sinusoid(0, x.shape[1], cfg.d_model, x.dtype, x.device)[None]

    # ---- training ----
    def loss(self, params, batch, remat: bool = True, remat_policy=None):
        """Mean next-token CE of the decoder over ``batch`` {"frames" [B,
        enc_seq, D], "tokens", "labels" [B, S] int} -> (ce, {"ce", "aux": 0}),
        as the reference's: position i is scored against labels[i + 1]
        (ROADMAP queue C's double shift, kept).  ``remat`` recomputes each
        decoder layer in backward; with it, a ``remat_policy``
        (``OffloadPolicy``) runs each decoder layer instead, with the
        encoder's output among the tensors it owes a gradient.  The encoder
        is never rematerialised."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = self._embed_dec(params, batch["tokens"])
        for p, spec in zip(params["decoder"], layer_specs(cfg.program)):
            # An alias a layer: the gradients of the layer's cross k and v
            # meet there before the layers' sums meet at enc_out, in every
            # path alike (a policy's layer returns its sum as one tensor), so
            # remat, no remat and a policy give the same bits.
            e = enc_out.view_as(enc_out)
            if remat and remat_policy is not None:
                fn = partial(train_layer, p, cfg=cfg, spec=spec, angles=None, enc_out=e)
                x, _ = remat_policy.run_layer(fn, x, tree_leaves(p) + [e])
            elif remat:  # no layer draws random numbers, so no RNG state is saved
                x, _ = checkpoint(train_layer, p, x, cfg, spec, None, e, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, _ = train_layer(p, x, cfg, spec, None, enc_out=e)
        x = apply_norm(params["final_norm"], x, cfg)
        ce = chunked_softmax_xent(x[:, :-1], params["embed"], batch["labels"][:, 1:], cfg)
        return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}

    # ---- serving ----
    def init_cache(self, batch: int, max_seq: int):
        """Each decoder layer's zeroed self K/V cache and cross cache."""
        return init_program_cache(self.cfg, self.cfg.program, batch, max_seq,
                                  dtype_of(self.cfg), self.device)

    def prefill(self, params, batch, max_seq: int | None = None):
        """Encode ``batch["frames"]``, forward ``batch["tokens"]`` through the
        decoder -> (last-position logits [B,1,V], the filled cache)."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        x = self._embed_dec(params, batch["tokens"])
        max_seq = max_seq or x.shape[1]
        cache = []
        for p, spec in zip(params["decoder"], layer_specs(cfg.program)):
            x, c = prefill_layer(p, x, cfg, spec, None, max_seq, enc_out=enc_out)
            cache.append(c)
        # Row-wise norm: the last position alone equals the reference's slice.
        x = apply_norm(params["final_norm"], x[:, -1:].contiguous(), cfg)
        return lm_logits(params["embed"], x, cfg), cache

    def decode_step(self, params, cache, tokens, pos):
        """tokens [B,1] int, pos a 0-d integer tensor (or an int, made one on
        tokens' device) -> (logits [B,1,V], cache updated in place)."""
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        pos = position_tensor(pos, tokens.device)
        x = x + sinusoid_row(pos, cfg.d_model, x.dtype)
        for p, c, spec in zip(params["decoder"], cache, layer_specs(cfg.program)):
            x, _ = decode_layer(p, x, c, pos, cfg, spec, None)
        x = apply_norm(params["final_norm"], x, cfg)
        return lm_logits(params["embed"], x, cfg), cache
