"""AdamW + global-norm clipping (counterpart of ``repro/optim/adamw.py``).

The state is two pytrees (m, v) mirroring the params, fp32 by default, and
the step count.  The defaults are the reference's: b1 0.9, b2 0.95, eps
1e-8, weight decay 0.1 on every leaf, clipping at a global norm of 1.0.
Unlike the reference's pure functions, the port updates in place, one
tensor at a time: the clip scales each gradient with ``mul_``, and m, v and
the params are rewritten where they lie.  At qwen3-4b's width the params,
gradients, m and v are 16 GB each in fp32, so a whole-model temporary
would not fit beside them on an 80 GB card.

Each leaf's update is the reference's ``upd``: m2, v2, the step and the new
param are computed in fp32 from the stored values, and each stored result
is rounded to its dtype once.  The temporaries, each of one leaf's size in
fp32: with fp32 moments, m and v are updated in place and the step takes
two (m2 / bc1, then sqrt(v2 / bc2) + eps); with bf16 moments, m2 and v2 are
the two, written back to m and v before they hold the step.  An fp32 param
is updated in place (``p.float()`` is p itself), so fp32 masters take no
more; a bf16 param takes one more for its fp32 value, as a bf16 gradient
does for ``g.float()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.tree import map_tree, tree_leaves


@dataclass
class AdamWState:
    m: Any
    v: Any
    count: int


def adamw_init(params, dtype=torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    return AdamWState(m=map_tree(zeros, params), v=map_tree(zeros, params), count=0)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sq = None
    for g in tree_leaves(grads):
        gf = g.reshape(-1).float()
        part = torch.dot(gf, gf)
        sq = part if sq is None else sq + part
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_step(params, grads, state: AdamWState, lr: float, *, b1: float = 0.9,
               b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
               max_grad_norm: float | None = 1.0):
    """One AdamW update of ``params`` from ``grads`` (clipped in place first);
    returns (params, new state, {"grad_norm"}), params, m and v updated in
    place.  The bias corrections are computed in fp32 from the count."""
    if max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    c = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** c)
    decay = 1.0 - lr * weight_decay
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        gf = g.float()
        m2 = m.float().mul_(b1).add_(gf, alpha=1 - b1)
        v2 = v.float().mul_(b2).addcmul_(gf, gf, value=1 - b2)
        own_m, own_v = m2 is not m, v2 is not v  # fp32 temporaries of bf16 moments
        if own_m:
            m.copy_(m2)
        if own_v:
            v.copy_(v2)
        denom = (v2.div_(bc2) if own_v else v2 / bc2).sqrt_().add_(eps)
        step = (m2.div_(bc1) if own_m else m2 / bc1).div_(denom)
        del m2, v2, denom
        p2 = p.float()
        p2.mul_(decay).sub_(step.mul_(lr))
        if p2 is not p:
            p.copy_(p2)
    return params, AdamWState(state.m, state.v, count), {"grad_norm": gnorm}
