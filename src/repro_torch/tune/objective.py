"""SLO-weighted stall objective over runtime reports.

Counterpart of ``repro/tune/objective.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_colocate.py``
holds the two equal.

The tuners in this package all minimize the same scalar: each completed
tenant's excess seconds (overhead beyond its isolated baseline, plus the
queue wait it spent un-admitted), weighted by its SLO ``priority``.  The
attribution ledger decomposes the same overhead into named causes, so
``binding_constraint`` can report *why* the winning candidate's stall is
what it is: ``transfer`` means the plan swaps too much, ``channel_contention``
means the K DMA channels bind, ``blackout`` means the collective link
schedule binds.
"""

from __future__ import annotations

INFEASIBLE = float("inf")

# Ledger buckets (sum exactly to overhead_s) mapped to the constraint each
# one names.  Informational keys are excluded from the argmax.
_BUCKET_CONSTRAINT = {
    "swap_in_transfer_s": "transfer",
    "swap_out_pending_s": "transfer",
    "swap_out_drain_s": "transfer",
    "channel_contention_s": "channel_contention",
    "link_blackout_s": "blackout",
    "collective_excess_s": "blackout",
    "barrier_drain_s": "barrier",
    "residual_s": "residual",
}
_INFORMATIONAL = ("overhead_s", "queue_wait_s", "renegotiation_solve_s")


def slo_weighted_stall(report) -> float:
    """SLO-weighted total stall of a ``RuntimeReport``.

    sum over tenants of priority * (overhead_s + queue_wait_s), where
    overhead is seconds beyond the tenant's isolated baseline.  A tenant
    that never completed (unschedulable) or a pool overflow makes the
    configuration infeasible — returns ``inf`` so tuners reject it.
    """
    if report.overflow_events:
        return INFEASIBLE
    total = 0.0
    for t in report.tenants:
        if t.status != "completed":
            return INFEASIBLE
        excess = max(0.0, t.duration_s - t.baseline_s)
        total += t.priority * (excess + t.queue_wait_s)
    return total


def binding_constraint(attribution: dict | None) -> str:
    """Name the constraint behind the largest attribution bucket.

    ``attribution`` is a tenant (or report-aggregate) stall ledger; returns
    one of ``transfer`` / ``channel_contention`` / ``blackout`` / ``barrier``
    / ``residual``, or ``none`` when there is no ledger or no stall at all.
    """
    if not attribution:
        return "none"
    best_k, best_v = None, 0.0
    for k, v in attribution.items():
        if k in _INFORMATIONAL:
            continue
        if v > best_v:
            best_k, best_v = k, v
    if best_k is None:
        return "none"
    return _BUCKET_CONSTRAINT.get(best_k, best_k)
