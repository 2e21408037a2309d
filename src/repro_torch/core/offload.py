"""AutoSwap's selection as named activation classes to offload.

Counterpart of ``repro/core/offload.py``, of which the port keeps the data:
``KNOWN_NAMES``, ``OffloadPlan`` (the same four fields in the same order, so
plan artifacts carry across) and ``remat_policy_for``.  The plan's executor,
the reference's ``OffloadPlan.policy()`` (a ``pinned_host`` remat policy),
becomes a torch saved-tensor policy in ROADMAP queue A6; until then an
``OffloadPlan`` here is what ``OffloadLowering`` solved, not something that
runs.
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


def remat_policy_for(names: list[str]) -> OffloadPlan:
    unknown = [n for n in names if n not in KNOWN_NAMES]
    if unknown:
        raise ValueError(f"unlabelled activation classes {unknown}; known: {KNOWN_NAMES}")
    return OffloadPlan(offload_names=list(names))
