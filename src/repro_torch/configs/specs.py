"""Meta-tensor input stand-ins for every (arch x shape) cell.

Counterpart of ``repro/configs/specs.py``: ``input_specs(cfg, shape)``
returns the keyword arguments of the step a cell runs (the loss for
``train``, prefill, or a decode step), as meta tensors: shapes and dtypes,
no memory.  ``core.trace`` traces a step at them.  Token ids and
positions are int64, the port's (``repro_torch.data``); the reference's
are int32.  An encoder-decoder's cell takes the frames in the config's
dtype beside the tokens; a vision cell (qwen2-vl) takes
``num_patch_tokens`` patch embeddings in the config's dtype, the text
tokens that fill the rest of the sequence, and the [3, B, S] (t/h/w)
positions, as the reference's (its ``:42-45``).  ``cache_specs`` gives a
decode cell's cache: for hymba's long_500k, full caches in its 3 global
layers, window rings in the rest.
"""

from __future__ import annotations

import torch

from .base import SHAPES, ModelConfig, ShapeSpec

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def supports_shape(cfg: ModelConfig, shape: str) -> bool:
    """long_500k runs only for sub-quadratic (SSM/hybrid) archs; encoder-only
    models would skip decode shapes (none assigned here)."""
    sp = SHAPES[shape]
    if sp.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """{"batch": {["frames", ]"tokens"[, "patch_embeds", "positions"][,
    "labels"]}} for train and prefill cells; {"tokens", "pos"} for decode,
    where ``pos`` is the 0-d integer tensor the port's ``decode_step`` takes
    (the reference's int32 scalar).  A vision cell's labels take the text
    tokens' shape, [B, S - num_patch_tokens]."""
    sp: ShapeSpec = SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    act = getattr(torch, cfg.dtype)
    if sp.kind in ("train", "prefill"):
        batch = {}
        if cfg.is_encoder_decoder:
            batch["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), act)
            batch["tokens"] = _meta((B, S), torch.long)
        elif cfg.frontend == "vision_stub":
            npatch = cfg.num_patch_tokens
            batch["tokens"] = _meta((B, S - npatch), torch.long)
            batch["patch_embeds"] = _meta((B, npatch, cfg.d_model), act)
            batch["positions"] = _meta((3, B, S), torch.long)
        else:
            batch["tokens"] = _meta((B, S), torch.long)
        if sp.kind == "train":
            batch["labels"] = _meta(tuple(batch["tokens"].shape), torch.long)
        return {"batch": batch}
    return {"tokens": _meta((B, 1), torch.long), "pos": _meta((), torch.long)}


def cache_specs(model, cfg: ModelConfig, shape: str):
    """The decode cache of a decode cell, as meta tensors."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import init_program_cache

    sp = SHAPES[shape]
    return init_program_cache(cfg, cfg.program, sp.global_batch, sp.seq_len, dtype_of(cfg),
                              "meta")
