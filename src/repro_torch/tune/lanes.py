"""Directional HostLink lane allocation.

Counterpart of ``repro/tune/lanes.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_colocate.py``
holds the two equal.

A shared lane pool is work-conserving, but it lets a burst of bulk
swap-outs queue ahead of a latency-critical swap-in on every lane at once.
``HostLink.make(..., out_lanes=k)`` carves the pool so swap-ins keep
reserved lanes; this module picks ``k`` from measured evidence — the
per-direction decomposition of the link's queue wait (``wait_in_s`` /
``wait_out_s``, the directional split of what the stall ledger books as
``channel_contention_s``) in a probe run, falling back to the byte split
when the probe saw no queueing at all.

``dist.execute.run_mesh(lane_split="directional")`` runs the probe and
applies the split.
"""

from __future__ import annotations


def lane_split_from_waits(
    wait_in_s: float,
    wait_out_s: float,
    lanes: int,
    bytes_in: int = 0,
    bytes_out: int = 0,
) -> int | None:
    """Out-lane count for a directional split, or ``None`` for no split.

    Lanes go to each direction proportionally to its measured queue wait
    (demand the shared pool failed to serve immediately); when neither
    direction ever waited, proportionally to bytes moved.  Each direction
    always keeps at least one lane.  ``None`` when ``lanes < 2`` or there
    is no directional evidence at all.
    """
    if lanes < 2:
        return None
    demand_in, demand_out = max(0.0, wait_in_s), max(0.0, wait_out_s)
    if demand_in + demand_out <= 0.0:
        demand_in, demand_out = float(bytes_in), float(bytes_out)
    total = demand_in + demand_out
    if total <= 0.0:
        return None
    out_lanes = round(lanes * demand_out / total)
    return max(1, min(int(out_lanes), lanes - 1))
