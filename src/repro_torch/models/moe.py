"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Counterpart of ``repro/models/moe.py`` (``init_moe``, ``_route``,
``apply_moe``; ``apply_moe_shardmap`` waits for ROADMAP.md queue A item 12).
Token-expert pairs are sorted by expert with a stable sort, ranked within
their expert, and dropped beyond the capacity C = ceil(T k / E cf), rounded
up to a multiple of 8 and at least 8.  Routers: softmax top-k with
renormalised gates (deepseek) or sigmoid top-1 (llama4); the router is
stored and applied in fp32, as the reference's.  The Switch-style aux loss
is returned, as the reference's: serving drops it, and training adds 0.01
times the layers' sum to the loss (``transformer.Model.loss``).  In the
backward, ``index_select``'s gradient adds each pair's row into its slot
with ``index_add``; the kept slots are distinct and the dropped pairs' rows
all land on the spare row, which is discarded, so each kept row is added
once and the gradient does not depend on the order of atomic adds.

Every shape is static, so that a step traces on fake tensors and reads
nothing back to the host:

  * the reference scatters with ``mode="drop"``: here each group's buffer
    has E C + 1 rows, and the pairs beyond capacity all write the spare
    last row, which no expert reads;
  * the reference gathers with ``mode="fill"``: the experts' output gets a
    zero row in the same place, which the dropped pairs read;
  * the reference adds the gated rows into their tokens with a scatter-add;
    here each pair finds its row directly (its slot, in pair order), and
    the k rows of a token are summed in a fixed order, so the result does
    not depend on the order of atomic adds on the card.

The expert products are batched GEMMs over E (``torch.bmm``), as the
reference's einsums are outside any Pallas kernel.  Tokens form G groups
with group-local capacity, as in the reference's layout; one device is one
group (the reference's ``token_group_count()`` without a mesh).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .layers import apply_dense_ffn, dtype_of, init_dense_ffn, normal


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype | None = None):
    """Experts stored as ``dtype`` (``cfg.dtype`` by default); the router fp32."""
    d, f, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    dt = dtype or dtype_of(cfg)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": normal(generator, (d, E), s_in, torch.float32),
        "w_gate": normal(generator, (E, d, f), s_in, dt),
        "w_up": normal(generator, (E, d, f), s_in, dt),
        "w_down": normal(generator, (E, f, d), s_out, dt),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_dense_ffn(generator, cfg, dt, d_ff=f * cfg.num_shared_experts)
    return p


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows a group gives each expert: the reference's C for ``tokens`` a group."""
    C = math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-C // 8) * 8)


def _route(p, xt, cfg: ModelConfig):
    """xt [T, D] -> (gates [T,k] fp32, idx [T,k], aux_loss scalar, probs [T,E]
    fp32): the reference's three, and the probabilities the top-k ran on."""
    logits = xt.float() @ p["router"].float()
    k, E = cfg.top_k, cfg.num_experts
    if cfg.router_type == "sigmoid":
        probs = torch.sigmoid(logits)
        gates, idx = torch.topk(probs, k, dim=-1)
        p_e = torch.softmax(logits, dim=-1).mean(0)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        p_e = probs.mean(0)
    # Switch-style load-balance aux: E * sum_e f_e * p_e, f_e the share of
    # tokens that picked expert e (the reference's one-hot sum, as counts).
    picks = torch.zeros(E, device=xt.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=xt.device))
    aux = E * torch.sum(picks / xt.shape[0] * p_e)
    return gates, idx, aux, probs


# The hook ``apply_moe`` hands each call's routing to, on any thread.
_HOOK = [None]


@contextlib.contextmanager
def routing_hook(hook):
    """While active, each ``apply_moe`` calls ``hook(record)`` with its
    routing: ``probs`` [T, E], ``idx`` [T, k], ``rank`` [T, k] (each pair's
    place among its expert's pairs in its group, in token order) and
    ``capacity``; a pair is kept when its rank is below the capacity.  How a
    comparison of two runs holds their routing equal.  The hook is the
    process's, not the thread's: on the card the autograd engine runs a
    layer's recompute (remat, an offload policy) on its own device thread,
    and a training run's records hold each MoE layer's forward, then, in
    backward, its recompute, top layer first."""
    prev = _HOOK[0]
    _HOOK[0] = hook
    try:
        yield
    finally:
        _HOOK[0] = prev


def apply_moe(p, x, cfg: ModelConfig):
    """x [B, S, D] -> (y [B, S, D], aux_loss)."""
    dt = x.dtype
    B, S, D = x.shape
    T = B * S
    k, E = cfg.top_k, cfg.num_experts
    G = 1  # token groups: one device is one (the distributed slice widens it)
    Tg = T // G
    dev = x.device
    xt = x.reshape(T, D)

    gates, idx, aux, probs = _route(p, xt, cfg)
    C = capacity(Tg, cfg)
    rows = E * C + 1                       # the last row of a group takes the dropped pairs

    flat_e = idx.reshape(G, Tg * k)        # pair (t, j) of the group at t * k + j
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    start = torch.searchsorted(sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
    rank_sorted = torch.arange(Tg * k, device=dev) - start.gather(1, sorted_e)
    slot_sorted = torch.where(rank_sorted < C, sorted_e * C + rank_sorted, E * C)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    slot = (slot + torch.arange(G, device=dev)[:, None] * rows).reshape(T, k)

    hook = _HOOK[0]
    if hook is not None:
        rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
        # Detached: a record kept past the step must not hold the autograd
        # graph behind probs, which for a remat recompute is the layer's
        # whole recomputed graph with its saved tensors.
        hook({"probs": probs.detach(), "idx": idx, "rank": rank.reshape(T, k),
              "capacity": C})

    # Dispatch: each token's row into its k slots (the kept slots are distinct).
    buf = x.new_zeros(G * rows, D)
    buf.index_put_((slot,), xt.view(T, 1, D))
    h = buf.view(G, rows, D)[:, :E * C].reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    g_ = torch.bmm(h, p["w_gate"].to(dt))
    u = torch.bmm(h, p["w_up"].to(dt))
    y = torch.bmm(F.silu(g_) * u, p["w_down"].to(dt))                   # [E, G C, D]
    y = y.view(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    y = F.pad(y, (0, 0, 0, 1)).view(G * rows, D)                       # zero row: dropped
    # Combine: each pair's row, gated, summed over a token's k pairs in order.
    out = (y.index_select(0, slot.reshape(-1)).view(T, k, D) * gates.to(dt)[..., None]).sum(1)

    if cfg.num_shared_experts:
        out = out + apply_dense_ffn(p["shared"], xt, cfg)
    return out.reshape(B, S, D), aux
