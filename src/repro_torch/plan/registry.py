"""Strategy registry: pool methods and swap scorers addressable by name.

Counterpart of ``repro/plan/registry.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_plan.py``
holds the two equal.

Pool methods map ``IterationTrace -> AllocationPlan`` (offline solvers) or
``IterationTrace -> PoolStats`` (online/exact baselines).  Swap scorers map
``(AutoSwapPlanner, limit, weights) -> list[SwapDecision]``.  Registering by
name is what lets launchers, benchmarks, and serialized artifacts refer to
strategies without importing their implementations — the seam where future
allocators/scorers plug in.
"""

from __future__ import annotations

from typing import Callable

from ..core.autoswap import AutoSwapPlanner
from ..core.baseline_pools import CnMemPool, PoolStats, exact_allocator
from ..core.events import IterationTrace
from ..core.simulator import SwapDecision
from ..core.smartpool import AllocationPlan, solve as smartpool_solve

PoolFn = Callable[[IterationTrace], "AllocationPlan | PoolStats"]
ScorerFn = Callable[..., "list[SwapDecision]"]

_POOLS: dict[str, PoolFn] = {}
_SCORERS: dict[str, ScorerFn] = {}


def register_pool(name: str):
    def deco(fn: PoolFn) -> PoolFn:
        _POOLS[name] = fn
        return fn

    return deco


def register_scorer(name: str):
    def deco(fn: ScorerFn) -> ScorerFn:
        _SCORERS[name] = fn
        return fn

    return deco


def get_pool(name: str) -> PoolFn:
    if name not in _POOLS:
        raise KeyError(f"unknown pool method {name!r}; known: {pool_names()}")
    return _POOLS[name]


def get_scorer(name: str) -> ScorerFn:
    if name not in _SCORERS:
        raise KeyError(f"unknown swap scorer {name!r}; known: {scorer_names()}")
    return _SCORERS[name]


def pool_names() -> tuple[str, ...]:
    return tuple(sorted(_POOLS))


def scorer_names() -> tuple[str, ...]:
    return tuple(sorted(_SCORERS))


# ----------------------------------------------------------- built-in pools
@register_pool("best_fit")
def _best_fit(trace: IterationTrace) -> AllocationPlan:
    return smartpool_solve(trace, "best_fit")


@register_pool("first_fit")
def _first_fit(trace: IterationTrace) -> AllocationPlan:
    return smartpool_solve(trace, "first_fit")


@register_pool("cnmem")
def _cnmem(trace: IterationTrace) -> PoolStats:
    return CnMemPool().run(trace)


@register_pool("exact")
def _exact(trace: IterationTrace) -> PoolStats:
    return exact_allocator(trace)


# --------------------------------------------------------- built-in scorers
def _priority_scorer(method: str) -> ScorerFn:
    def scorer(planner: AutoSwapPlanner, limit: int, weights=None) -> list[SwapDecision]:
        # Explicit weights override the named score (combined-score semantics,
        # same as AutoSwapPlanner.select / the "bo" scorer).
        return planner.select(limit, method, weights)

    return scorer


for _m in ("doa", "aoa", "wdoa", "swdoa"):
    register_scorer(_m)(_priority_scorer(_m))


@register_scorer("bo")
def _bo(planner: AutoSwapPlanner, limit: int, weights=None) -> list[SwapDecision]:
    """Bayesian-optimized combined score (paper §IV-C).  Explicit weights skip
    the tuner; otherwise GP-EI minimizes simulated overhead at this limit."""
    if weights is None:
        from ..core.bayesopt import tune_swap_weights

        weights = list(tune_swap_weights(planner, limit, n_iter=16).best_x)
    return planner.select(limit, None, list(weights))
