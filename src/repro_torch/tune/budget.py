"""SLO-equalized colocation budget splits.

Counterpart of ``repro/tune/budget.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_colocate.py``
holds the two equal.

``proportional_shares`` splits a shared HBM budget by isolated peak bytes —
a byte heuristic blind to how *sensitive* each tenant's stall is to its
share.  ``tuned_shares`` is a coordinate-descent tuner over the split: it
starts from the proportional split and repeatedly moves ``delta`` bytes
from a donor tenant to a receiver, keeping any move that strictly reduces
SLO-weighted total stall (measured by re-simulating the colocation under
the trial split), halving ``delta`` when a full sweep finds nothing.  At
convergence no +/-delta transfer helps — the discrete form of equalized
SLO-weighted *marginal* stall across tenants.

The tuner is simulation-agnostic: ``evaluate(shares) -> float`` is any
callback returning the objective for a split (``inf`` = infeasible).
``runtime.tenants.colocate_programs(budget_split="tuned")`` wires it to a
full colocation re-simulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BudgetSplitResult:
    """A tuned split next to its proportional starting point."""

    shares: dict[str, int]
    initial_shares: dict[str, int]
    initial_stall: float
    tuned_stall: float
    rounds: int = 0
    evals: int = 0
    moves: list[dict] = field(default_factory=list)

    @property
    def improved(self) -> bool:
        return self.tuned_stall < self.initial_stall

    def as_dict(self) -> dict:
        return {
            "shares": dict(self.shares),
            "initial_shares": dict(self.initial_shares),
            "initial_stall_s": self.initial_stall,
            "tuned_stall_s": self.tuned_stall,
            "rounds": self.rounds,
            "evals": self.evals,
            "moves": list(self.moves),
        }


def tuned_shares(
    peaks: dict[str, int],
    budget: int,
    evaluate,
    start: dict[str, int] | None = None,
    delta_frac: float = 0.125,
    min_delta: int = 1 << 20,
    max_evals: int = 64,
) -> BudgetSplitResult:
    """Coordinate descent on the budget split, minimizing ``evaluate``.

    ``peaks`` caps each tenant's share (bytes above its natural peak are
    wasted); shares always sum to ``budget``.  ``start`` defaults to the
    proportional split.  Descent is monotone — every accepted move strictly
    reduces the objective — so the result is never worse than the start.
    """
    from ..runtime.tenants import proportional_shares

    names = sorted(peaks)
    if start is None:
        start = proportional_shares(peaks, budget)
    cur = {n: min(start[n], peaks[n]) for n in names}
    cur_score = evaluate(cur)
    result = BudgetSplitResult(
        shares=dict(cur), initial_shares=dict(cur),
        initial_stall=cur_score, tuned_stall=cur_score, evals=1,
    )
    delta = max(int(min_delta), int(budget * delta_frac))
    while delta >= min_delta and result.evals < max_evals:
        result.rounds += 1
        improved = False
        for donor in names:
            for receiver in names:
                if receiver == donor or result.evals >= max_evals:
                    continue
                move = min(delta, peaks[receiver] - cur[receiver], cur[donor])
                if move <= 0:
                    continue
                trial = dict(cur)
                trial[donor] -= move
                trial[receiver] += move
                score = evaluate(trial)
                result.evals += 1
                if score < cur_score:  # strict: ties keep the simpler split
                    cur, cur_score = trial, score
                    improved = True
                    result.moves.append({
                        "from": donor, "to": receiver,
                        "bytes": move, "stall_s": score,
                    })
        if not improved:
            delta //= 2
    result.shares = dict(cur)
    result.tuned_stall = cur_score
    return result
