"""AutoSwap's selection as named activation classes to offload.

Counterpart of ``repro/core/offload.py``: ``KNOWN_NAMES``, ``OffloadPlan``
(the same four fields in the same order, so plan artifacts carry across)
and ``remat_policy_for``.  ``OffloadPlan.policy()`` executes the plan, as
the reference's ``pinned_host`` remat policy does: an ``OffloadPolicy``
(``core/offload_exec.py``, imported only when a policy is built, so the
planner's modules import no torch) that ``Model.loss(remat_policy=)``
applies per layer, copying the offloaded activations to pinned host memory
after the forward and back before the backward.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Activation classes the models label (the reference's checkpoint_name tags).
KNOWN_NAMES = ("block_in", "attn_out", "ffn_out")


@dataclass
class OffloadPlan:
    offload_names: list[str] = field(default_factory=list)
    save_names: list[str] = field(default_factory=list)
    # planner-predicted per-device HBM relief (bytes) and transfer volume
    predicted_savings: int = 0
    transfer_bytes: int = 0

    def policy(self):
        """The ``OffloadPolicy`` executing this plan, or None (plain full
        remat) when it names nothing to offload or save."""
        if not self.offload_names and not self.save_names:
            return None
        from .offload_exec import OffloadPolicy

        return OffloadPolicy(self.offload_names, self.save_names)


def remat_policy_for(names: list[str]) -> OffloadPlan:
    unknown = [n for n in names if n not in KNOWN_NAMES]
    if unknown:
        raise ValueError(f"unlabelled activation classes {unknown}; known: {KNOWN_NAMES}")
    return OffloadPlan(offload_names=list(names))
