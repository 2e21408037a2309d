"""Carry a JAX ``Model.init`` pytree (as numpy arrays) into the port's layout.

The reference stacks the layers of a repeated program segment on a leading
axis (``repro/models/transformer.py:279 init_program``, built with
``jax.vmap``) and scans over it; the port keeps one entry per layer.
``unstack_program`` turns the one form into the other for any per-segment
pytree, the parameters and the KV cache alike; ``params_from_jax`` also
casts matrices to ``cfg.dtype`` or a dtype asked for (norm scales stay
fp32) and moves them to the device, and ``adamw_from_jax`` carries the
optimizer's state.  Parameter names and einsum layouts are the reference's;
the KV cache's is not (``kv_from_jax``, ``cache_from_jax``), while the
Mamba-2 cache's is.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import map_tree
from .layers import dtype_of


def unstack_program(segs, program) -> list:
    """Per-segment pytrees (leaves [reps, ...] when reps > 1) -> one pytree per layer."""
    layers = []
    for (unit, reps), seg in zip(program, segs):
        for r in range(reps):
            for i in range(len(unit)):
                node = seg[f"l{i}"]
                layers.append(map_tree(lambda a, r=r: a[r], node) if reps > 1 else node)
    return layers


def params_from_jax(np_params, cfg: ModelConfig, device, dtype=None):
    """JAX ``Model.init`` params as numpy -> the port's params on ``device``,
    matrices stored as ``dtype`` (``cfg.dtype`` when None; ``torch.float32``
    keeps the reference's masters for training)."""
    dt = dtype or dtype_of(cfg)

    def leaf(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=dt if t.ndim >= 2 else torch.float32)

    return {
        "embed": map_tree(leaf, np_params["embed"]),
        "blocks": [map_tree(leaf, p) for p in unstack_program(np_params["blocks"], cfg.program)],
        "final_norm": map_tree(leaf, np_params["final_norm"]),
    }


def adamw_from_jax(np_state, cfg: ModelConfig, device) -> AdamWState:
    """The reference's ``AdamWState`` (leaves as numpy) -> the port's, with
    fp32 moments on ``device`` and the count as an int."""
    return AdamWState(m=params_from_jax(np_state.m, cfg, device, torch.float32),
                      v=params_from_jax(np_state.v, cfg, device, torch.float32),
                      count=int(np_state.count))


def _f32(a, device="cpu"):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def kv_from_jax(a, device="cpu"):
    """One layer's JAX cache leaf [B, W, KV, hd] -> the port's head-major
    [B, KV, W, hd] (``models/attention.py``), in float32."""
    return _f32(a).transpose(1, 2).contiguous().to(device)


def cache_from_jax(np_cache, cfg: ModelConfig, device="cpu") -> list:
    """JAX ``prefill``/``decode_step`` cache (per segment, leaves [reps, ...])
    -> the port's per-layer list of {"kv": {"k", "v"}} or {"ssm": {"state",
    "conv"}}, in float32.  KV leaves change layout (``kv_from_jax``); the
    ssm state [B,H,P,N] and conv tail [B,K-1,C] keep the reference's."""
    def leaf(kind):
        fn = kv_from_jax if kind == "kv" else _f32
        return lambda a: fn(a, device)

    return [{kind: map_tree(leaf(kind), c) for kind, c in layer.items()}
            for layer in unstack_program(np_cache, cfg.program)]


def to_device(tree, device):
    """Every tensor of ``tree`` moved to ``device``."""
    return map_tree(lambda t: t.to(device), tree)
