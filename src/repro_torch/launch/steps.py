"""Step builders (counterpart of ``repro/launch/steps.py``): the train,
prefill and serve steps.

``build_train_step`` is the reference's (``steps.py:174``) unsharded:
``(params, opt_state, batch, step) -> (params, opt_state, metrics)``, with
``accum_steps`` micro-batches whose fp32 gradients add up in the params'
``.grad`` before one division.  Params are updated in place.
``build_prefill_step`` and ``build_serve_step`` are the reference's
(``steps.py:217,224``): ``(params, batch) -> (logits, cache)`` and
``(params, cache, tokens, pos) -> (logits, cache)``, where ``pos`` is a
0-d integer tensor on the model's device and the cache is updated in
place; for a ``Model`` and an ``EncDecModel`` alike (whose batch holds
the frames too, and whose cache the cross K/V).

The sharding rules are the reference's (``steps.py:30-165``) as plain
data: ``param_specs``, ``cache_specs_tree`` and ``batch_specs`` give a
``distributed.PartitionSpec`` for each leaf of the port's trees, on any
mesh with ``axis_names`` and ``shape`` (``launch.shardplan.SpecMesh``):

  * attention heads / FFN hidden / vocab / experts  -> "model"
  * batch -> ("pod", "data"); gradient reduction crosses pods once per step
  * optional FSDP (``FSDP_ARCHS``): the non-"model" weight dim also over
    "data"
  * every rule degrades to replication where the mesh axes do not divide
    the dim (e.g. hymba's 50 SSM heads on model=16)

The port's layers are unstacked (``models/convert.py``), so no leaf has
the reference's leading repeat dim, and its attention K/V caches are
head-major ([B, KV, W, hd] where the reference's are [B, W, KV, hd]), so
their rule names the same axes with dims 1 and 2 swapped.  Each spec is
held to the reference's on its counterpart leaf by
``tests/test_torch_shardplan.py``.  ``with_sharding`` and
``opt_specs_like`` wait for ROADMAP A12d: nothing in the port executes
sharded yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import PartitionSpec as P, batch_axes
from repro_torch.optim.adamw import adamw_step
from repro_torch.tree import map_tree, map_tree_with_keys, tree_leaves

# FSDP is on for archs whose param+optimizer bytes exceed one chip's HBM at
# model-parallel 16.
FSDP_ARCHS = {"llama4-maverick-400b-a17b", "deepseek-v2-lite-16b"}


# --------------------------------------------------------------- divisibility
def _ax(mesh, name, dim: int):
    """Mesh axis (or axes) for one tensor dim, with divisibility guard."""
    if name is None:
        return None
    names = name if isinstance(name, tuple) else (name,)
    names = tuple(n for n in names if n in mesh.axis_names)
    if not names:
        return None
    size = math.prod(mesh.shape[n] for n in names)
    if dim % size != 0:
        # try a prefix that divides
        for k in range(len(names), 0, -1):
            sub = names[:k]
            if dim % math.prod(mesh.shape[n] for n in sub) == 0:
                return sub if len(sub) > 1 else sub[0]
        return None
    return names if len(names) > 1 else names[0]


def _spec(mesh, dims: list, shape) -> P:
    """dims: logical mesh-axis names per tensor dim (right-aligned)."""
    pad = len(shape) - len(dims)
    dims = [None] * pad + list(dims)
    return P(*[_ax(mesh, d, s) for d, s in zip(dims, shape)])


# ------------------------------------------------------------- param specs
def param_specs(cfg: ModelConfig, param_shapes, mesh, fsdp: bool | None = None):
    """PartitionSpec tree matching the param tree."""
    if fsdp is None:
        fsdp = cfg.name in FSDP_ARCHS
    dp = "data"

    def rule(path_keys, shape) -> P:
        name = path_keys[-1]
        parent = path_keys[-2] if len(path_keys) > 1 else ""
        if name in ("tok", "head"):                       # [V, D]
            return _spec(mesh, ["model", dp if fsdp else None], shape)
        if name == "wq":                                  # [D, H, hd] (attn + mla)
            return _spec(mesh, [dp if fsdp else None, "model", None], shape)
        if name in ("wk", "wv"):                          # [D, KV, hd]
            return _spec(mesh, [dp if fsdp else None, "model", None], shape)
        if name == "wo":                                  # [H, hd, D]
            return _spec(mesh, ["model", None, dp if fsdp else None], shape)
        if name in ("w_uk", "w_uv"):                      # [lora, H, *]
            return _spec(mesh, [None, "model", None], shape)
        if name == "w_dkv":                               # [D, lora]
            return _spec(mesh, [dp if fsdp else None, None], shape)
        if name == "w_kr":                                # [D, rope]
            return _spec(mesh, [dp if fsdp else None, None], shape)
        if name == "router":                              # [D, E]
            return _spec(mesh, [None, "model"], shape)
        if name in ("w_gate", "w_up"):
            if parent == "moe":                           # experts [E, D, F]
                return _spec(mesh, ["model", None, dp if fsdp else None], shape)
            return _spec(mesh, [dp if fsdp else None, "model"], shape)
        if name == "w_down":
            if parent == "moe":                           # [E, F, D]
                return _spec(mesh, ["model", dp if fsdp else None, None], shape)
            return _spec(mesh, ["model", dp if fsdp else None], shape)
        if name == "b_up":
            return _spec(mesh, ["model"], shape)
        if name == "in_proj":                             # [D, 2di+2gn+H]
            return _spec(mesh, [dp if fsdp else None, "model"], shape)
        if name in ("conv_w",):                           # [K, conv_dim]
            return _spec(mesh, [None, "model"], shape)
        if name in ("conv_b",):
            return _spec(mesh, ["model"], shape)
        if name == "out_proj":                            # [di, D]
            return _spec(mesh, ["model", dp if fsdp else None], shape)
        if name == "norm" and parent == "mamba":          # [di]
            return _spec(mesh, ["model"], shape)
        # norms, A_log, D, dt_bias, qk norms, branch norms, biases: replicate
        return P(*([None] * len(shape)))

    return map_tree_with_keys(lambda keys, leaf: rule(keys, leaf.shape), param_shapes)


def cache_specs_tree(cfg: ModelConfig, cache_shapes, mesh):
    """Specs for decode caches (the port's per-layer list)."""

    def rule(keys, leaf) -> P:
        name = keys[-1]
        shape = leaf.shape
        b = batch_axes(mesh)
        if name in ("k", "v"):                            # [B, KV, S, hd], self and cross
            spec = _spec(mesh, [b, "model", None, None], shape)
            if spec[1] is None:
                # KV heads don't divide the model axis (e.g. 8 on 16):
                # split-KV — shard the sequence dim of the cache instead,
                # decode softmax handles it (flash-decoding layout).
                spec = _spec(mesh, [b, None, "model", None], shape)
            return spec
        if name in ("c_kv", "k_rope"):                    # [B, S, lora]
            return _spec(mesh, [b, "model", None], shape)
        if name == "state":                               # [B, H, P, N]
            return _spec(mesh, [b, "model", None, None], shape)
        if name == "conv":                                # [B, K-1, conv_dim]
            return _spec(mesh, [b, None, "model"], shape)
        return P(*([None] * len(shape)))

    return map_tree_with_keys(rule, cache_shapes)


def batch_specs(cfg: ModelConfig, batch_shapes, mesh):
    b = batch_axes(mesh)

    def rule(keys, leaf) -> P:
        name = keys[-1]
        if name == "positions":                           # [3, B, S]
            return _spec(mesh, [None, b, None], leaf.shape)
        if name in ("tokens", "labels"):                  # [B, S]
            return _spec(mesh, [b, None], leaf.shape)
        if name in ("patch_embeds", "frames"):            # [B, S, D]
            return _spec(mesh, [b, None, None], leaf.shape)
        return _spec(mesh, [b] + [None] * (len(leaf.shape) - 1), leaf.shape)

    return map_tree_with_keys(rule, batch_shapes)


def build_train_step(model, cfg: ModelConfig, *, lr: float = 3e-4, remat: bool = True,
                     remat_policy=None, accum_steps: int = 1):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``batch`` holds [B, S] int tensors (and a vision stub's patches [B,
    npatch, D] and M-RoPE positions [3, B, S], or an encoder-decoder's
    frames [B, enc_seq, D]); with ``accum_steps`` > 1 it
    is cut into that many micro-batches along B, as the reference's reshape
    does, the positions along their axis 1 (the reference's reshape cuts
    their axis 0, the three channels, which fails).
    ``remat_policy`` (``OffloadPlan.policy()``, or None for plain remat)
    goes to ``Model.loss``, which applies it per layer under ``remat``.
    metrics: the last micro-batch's model metrics (``ce``, and ``aux``, the
    MoE layers' summed aux loss, 0 for a dense model), the mean ``loss``
    (each micro-batch's ``ce + 0.01 * aux``) and the ``grad_norm`` before
    clipping, as the reference's."""

    def train_step(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        B = batch["tokens"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} micro-batches")
        mb = B // accum_steps
        loss_sum = None
        for i in range(accum_steps):
            rows = slice(i * mb, (i + 1) * mb)
            micro = {k: v[:, rows] if k == "positions" else v[rows] for k, v in batch.items()}
            loss, metrics = model.loss(params, micro, remat=remat, remat_policy=remat_policy)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = map_tree(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)
        if accum_steps > 1:
            for g in tree_leaves(grads):
                g.div_(accum_steps)
        params, opt_state, om = adamw_step(params, grads, opt_state, lr)
        for t in leaves:
            t.grad = None
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss_sum / accum_steps, **om)

    return train_step


def build_prefill_step(model, cfg: ModelConfig):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def build_serve_step(model, cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return serve_step
