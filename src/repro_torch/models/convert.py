"""Carry a JAX ``Model.init`` pytree (as numpy arrays) into the port's layout.

The reference stacks the layers of a repeated program segment on a leading
axis (``repro/models/transformer.py:279 init_program``, built with
``jax.vmap``) and scans over it; the port keeps one entry per layer.
``unstack_program`` turns the one form into the other for any per-segment
pytree, the parameters and the KV cache alike; ``params_from_jax`` also
casts matrices to ``cfg.dtype`` or a dtype asked for (vectors, such as
norm scales, hybrid branch norms and Mamba-2's 1-D parameters, and MoE
routers stay fp32) and moves them to the device, and ``adamw_from_jax``
carries the optimizer's state.  Parameter names and einsum layouts are the
reference's, an encoder-decoder's tree (``embed``, ``encoder``,
``enc_norm``, ``decoder``, ``final_norm``) included; the attention KV
cache's layout is not, nor is the cross cache's (``kv_from_jax``,
``cache_from_jax``), while the MLA and Mamba-2 caches' are.
``cnn_params_from_jax`` carries a JAX ``CNN.init`` tree into the port's CNN
layout (``models/cnn.py``).
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
    keeps the reference's masters for training).  Vectors (norm scales, a
    hybrid layer's ``branch_norm_a``/``branch_norm_m``, Mamba-2's ``A_log``,
    ``D``, ``dt_bias``, ``norm`` and ``conv_b``, LayerNorm biases, the GELU
    FFN's ``b_up``/``b_down``; gemma's sandwich norms ``ln1_post``/``ln2_post``
    are norm scales too) and every MoE ``router`` stay fp32, as the
    reference keeps them.  An encoder-decoder's ``encoder`` and ``decoder``
    unstack as a decoder's ``blocks`` do."""
    dt = dtype or dtype_of(cfg)

    def leaf(a, keep_fp32=False):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=dt if t.ndim >= 2 and not keep_fp32 else torch.float32)

    def block(p):
        out = map_tree(leaf, p)
        if "moe" in p:
            out["moe"]["router"] = leaf(p["moe"]["router"], keep_fp32=True)
        return out

    def stack(segs, program):
        return [block(p) for p in unstack_program(segs, program)]

    if cfg.is_encoder_decoder:
        return {
            "embed": map_tree(leaf, np_params["embed"]),
            "encoder": stack(np_params["encoder"], cfg.enc_program),
            "enc_norm": map_tree(leaf, np_params["enc_norm"]),
            "decoder": stack(np_params["decoder"], cfg.program),
            "final_norm": map_tree(leaf, np_params["final_norm"]),
        }
    return {
        "embed": map_tree(leaf, np_params["embed"]),
        "blocks": stack(np_params["blocks"], cfg.program),
        "final_norm": map_tree(leaf, np_params["final_norm"]),
    }


def adamw_from_jax(np_state, cfg: ModelConfig, device) -> AdamWState:
    """The reference's ``AdamWState`` (leaves as numpy) -> the port's, with
    fp32 moments on ``device`` and the count as an int."""
    return AdamWState(m=params_from_jax(np_state.m, cfg, device, torch.float32),
                      v=params_from_jax(np_state.v, cfg, device, torch.float32),
                      count=int(np_state.count))


def cnn_params_from_jax(np_params, device, dtype=torch.float32):
    """JAX ``CNN.init`` params (or any tree of their shapes) as numpy -> the
    port's CNN params on ``device`` as ``dtype``: HWIO convolution weights
    become OIHW, the head ``[cin, classes]`` and the biases stay as they
    are, and ``None`` (VGG's pools) stays ``None``.  ``CNN.zero_momentum``
    gives SGD's momentum for them."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def leaf(a):
        if a is None:
            return None
        a = np.array(a, dtype=np_dtype)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return map_tree(leaf, np_params)


def _f32(a, device="cpu"):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def kv_from_jax(a, device="cpu"):
    """One layer's JAX cache leaf [B, W, KV, hd] -> the port's head-major
    [B, KV, W, hd] (``models/attention.py``), in float32."""
    return _f32(a).transpose(1, 2).contiguous().to(device)


def cache_from_jax(np_cache, cfg: ModelConfig, device="cpu") -> list:
    """JAX ``prefill``/``decode_step`` cache (per segment, leaves [reps, ...])
    -> the port's per-layer list of {"kv": {"k", "v"}}, {"kv": {"c_kv",
    "k_rope"}} (MLA), {"ssm": {"state", "conv"}} or, for a hybrid layer,
    both "kv" and "ssm", in float32; a decoder layer's cross cache, the
    reference's (k, v) pair, becomes "enc_kv": {"k", "v"}.  Attention KV
    leaves (full caches and window rings alike, slot for slot, and the
    cross K/V) change layout (``kv_from_jax``); the MLA latents [B,S,L],
    the ssm state [B,H,P,N] and conv tail [B,K-1,C] keep the reference's."""
    def part(kind, c):
        if kind == "enc_kv":
            return {"k": kv_from_jax(c[0], device), "v": kv_from_jax(c[1], device)}
        fn = kv_from_jax if kind == "kv" and "c_kv" not in c else _f32
        return map_tree(lambda a: fn(a, device), c)

    return [{kind: part(kind, c) for kind, c in layer.items()}
            for layer in unstack_program(np_cache, cfg.program)]


def to_device(tree, device):
    """Every tensor of ``tree`` moved to ``device``."""
    return map_tree(lambda t: t.to(device), tree)
