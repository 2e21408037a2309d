"""Meta-tensor input stand-ins for every (arch x shape) cell.

Counterpart of ``repro/configs/specs.py``: ``input_specs(cfg, shape)``
returns the keyword arguments of the step a cell runs (the loss for
``train``, prefill, or a decode step), as meta tensors: shapes and dtypes,
no memory.  ``core.trace`` traces a step at them.  Token ids are int64, the
port's (``repro_torch.data``); the reference's are int32.  The port has
the dense and Mamba-2 families only, so the reference's VLM patch
embeddings and encoder frames raise, naming ROADMAP queue A item 10.
"""

from __future__ import annotations

import torch

from .base import SHAPES, ModelConfig, ShapeSpec

NOT_PORTED = "is not yet ported, see ROADMAP.md queue A item 10"


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
    """{"batch": {"tokens"[, "labels"]}} for train and prefill cells;
    {"tokens", "pos"} for decode, where ``pos`` is the 0-d integer tensor
    the port's ``decode_step`` takes (the reference's int32 scalar)."""
    sp: ShapeSpec = SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}'s inputs ({cfg.frontend or 'encoder frames'}) "
                                  f"{NOT_PORTED}")
    if sp.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.long)}
        if sp.kind == "train":
            batch["labels"] = _meta((B, S), torch.long)
        return {"batch": batch}
    return {"tokens": _meta((B, 1), torch.long), "pos": _meta((), torch.long)}


def cache_specs(model, cfg: ModelConfig, shape: str):
    """The decode cache of a decode cell, as meta tensors."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import init_program_cache

    sp = SHAPES[shape]
    return init_program_cache(cfg, cfg.program, sp.global_batch, sp.seq_len, dtype_of(cfg),
                              "meta")
