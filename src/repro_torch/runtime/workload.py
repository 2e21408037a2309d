"""Seeded workload generation for dynamic-churn runtime experiments.

Counterpart of ``repro/runtime/workload.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

The runtime's churn model (tenants with ``arrival_t``/``priority``/optional
``departure_t``) needs arrival processes to drive it.  This module keeps the
generators deterministic and dependency-free:

* ``poisson_workload`` — the classic open-arrival model: exponential
  inter-arrival gaps at a given rate, templates/iteration counts/priorities
  drawn from a seeded ``random.Random``.  Same seed, same workload —
  bit-for-bit, which is what lets ``benchmarks/bench_churn.py`` compare
  renegotiation against FIFO queueing *under the same arrivals*.
* ``parse_arrivals`` — CLI surface (``repro.launch.colocate --arrivals``):
  either an explicit comma list of arrival times matched positionally to the
  tenant list, or ``poisson:rate=R[,seed=S][,start=T]``.
* ``synthetic_train_trace`` — a forward/backward-shaped ``IterationTrace``
  (weights live across the step, activations die in the backward pass) used
  as a tenant template when benchmarking the runtime without tracing a real
  model.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..core.events import IterationTrace, VariableInfo


@dataclass(frozen=True)
class WorkloadItem:
    """One tenant of a generated workload, before plans are solved."""

    name: str
    template: str          # which trace/program template instantiates it
    arrival_t: float
    iterations: int = 1
    priority: float = 1.0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "template": self.template,
            "arrival_t": self.arrival_t,
            "iterations": self.iterations,
            "priority": self.priority,
        }


def poisson_workload(
    templates: "list[str] | tuple[str, ...]",
    n: int,
    rate_hz: float,
    seed: int = 0,
    iterations: tuple[int, int] = (1, 1),
    priorities: "tuple[float, ...]" = (1.0,),
    start_t: float = 0.0,
) -> list[WorkloadItem]:
    """``n`` arrivals with Exp(rate) gaps starting from ``start_t``.

    Template, iteration count (uniform over the inclusive ``iterations``
    range) and priority are drawn from the same seeded stream, so one seed
    pins the entire workload.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    if not templates:
        raise ValueError("poisson_workload needs at least one template")
    rng = random.Random(seed)
    tpls = list(templates)
    t = float(start_t)
    items: list[WorkloadItem] = []
    for i in range(n):
        t += rng.expovariate(rate_hz)
        tpl = tpls[rng.randrange(len(tpls))]
        iters = rng.randint(iterations[0], iterations[1])
        prio = priorities[rng.randrange(len(priorities))]
        items.append(WorkloadItem(f"{tpl}#{i}", tpl, t, iters, prio))
    return items


def parse_arrivals(spec: str, n: int) -> list[float]:
    """Parse a CLI ``--arrivals`` spec into ``n`` arrival times.

    Two forms:
      * ``"0,0.002,0.005"`` — explicit times, matched positionally to the
        tenant list (must supply exactly ``n``);
      * ``"poisson:rate=500[,seed=0][,start=0]"`` — seeded Poisson process.
    """
    spec = spec.strip()
    if spec.startswith("poisson"):
        params = {"rate": 1000.0, "seed": 0.0, "start": 0.0}
        body = spec.partition(":")[2]
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            if not sep or k not in params:
                raise ValueError(
                    f"bad poisson arrival parameter {kv!r} (rate=|seed=|start=)"
                )
            params[k] = float(v)
        rng = random.Random(int(params["seed"]))
        t = params["start"]
        out = []
        for _ in range(n):
            t += rng.expovariate(params["rate"])
            out.append(t)
        return out
    times = [float(x) for x in spec.split(",") if x.strip()]
    if len(times) != n:
        raise ValueError(f"--arrivals lists {len(times)} times for {n} tenants")
    return times


def synthetic_train_trace(
    n_layers: int = 8,
    act_bytes: int = 8 << 20,
    weight_bytes: int = 4 << 20,
    flops_per_op: float = 1e9,
    bytes_per_op: float = 1e6,
) -> IterationTrace:
    """Forward/backward-shaped training trace (deterministic, no tracing).

    Per layer: a weight (lives the whole iteration, read in forward and
    backward) and an activation (written in forward, read by the mirrored
    backward op, freed right after) — the structure AutoSwap exploits, with
    op costs so the timing model produces non-trivial overlap.
    """
    vs: list[VariableInfo] = []
    var = 0
    n_ops = 4 * n_layers + 2
    fwd_w, fwd_a = [], []
    for l in range(n_layers):
        w = VariableInfo(var, weight_bytes, 0, n_ops, [2 * l], [False]); var += 1
        a = VariableInfo(var, act_bytes, 2 * l, 0, [2 * l + 1], [True]); var += 1
        vs.append(w); fwd_w.append(w)
        vs.append(a); fwd_a.append(a)
    for l in reversed(range(n_layers)):
        bwd_idx = 2 * n_layers + 2 * (n_layers - 1 - l) + 1
        fwd_w[l].accesses.append(bwd_idx)
        fwd_w[l].access_is_write.append(False)
        fwd_a[l].accesses.append(bwd_idx)
        fwd_a[l].access_is_write.append(False)
        fwd_a[l].free_index = bwd_idx + 1
    tr = IterationTrace(vs, n_ops)
    tr.op_costs = {i: (flops_per_op, bytes_per_op) for i in range(n_ops)}
    return tr
