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
place.  The reference's PartitionSpec rules (``param_specs`` and the rest)
wait for ROADMAP queue A item 12.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import adamw_step
from repro_torch.tree import map_tree, tree_leaves


def build_train_step(model, cfg: ModelConfig, *, lr: float = 3e-4, remat: bool = True,
                     remat_policy=None, accum_steps: int = 1):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``batch`` holds [B, S] int tensors; with ``accum_steps`` > 1 it is cut
    into that many micro-batches along B, as the reference's reshape does.
    ``remat_policy`` (``OffloadPlan.policy()``, or None for plain remat)
    goes to ``Model.loss``, which applies it per layer under ``remat``.
    metrics: the last micro-batch's model metrics, the mean ``loss`` and
    the ``grad_norm`` before clipping."""

    def train_step(params, opt_state, batch, step):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        B = next(iter(batch.values())).shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} micro-batches")
        mb = B // accum_steps
        loss_sum = None
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
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
