"""Ledger-driven renegotiation victim selection.

Counterpart of ``repro/tune/victim.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_colocate.py``
holds the two equal.

``FloorGreedyVictim`` (the engine default) shrinks the first eligible
victim by exactly the bytes the newcomer needs — it never asks what that
shrink *costs*.  ``LedgerVictimPolicy`` does: for each candidate
(victim, limit) pair it clones the live engine at the current loop-top
(``MemoryRuntime._probe_clone``), stages the candidate re-plan on the
clone, ``resume()``s the remaining horizon, and scores the simulated
future by SLO-weighted total stall.  The candidate minimizing the
objective is staged for real; the winner's attribution ledger names the
binding constraint (transfer / channel_contention / blackout) in the
policy's decision log.

Probe isolation is by construction: every candidate gets a *fresh* clone
of the pristine live state, so concurrent candidate probes at the same
barrier can never observe each other's staged reservations (the
double-counting bug this Issue's satellite pins with a regression test).
The clone swaps in a ``FloorGreedyVictim`` so downstream renegotiations
inside a probe never recurse into probing.
"""

from __future__ import annotations

from ..runtime.engine import VictimPolicy, planned_peak
from .objective import binding_constraint, slo_weighted_stall


class LedgerVictimPolicy(VictimPolicy):
    """Score K candidate (victim, limit) pairs by simulated marginal ledger.

    ``deferred=True``: the engine invokes ``choose`` at the next event-loop
    top, the only point where a snapshot/resume probe sees a consistent
    between-events state.  Candidates are the first ``max_victims`` eligible
    victims crossed with ``limit_fracs`` shrink depths (1.0 = exactly the
    bytes needed, lower = shrink deeper so the *next* newcomer may not need
    a renegotiation at all); infeasible solves (new floor doesn't free
    ``needed`` bytes) are dropped.  Ties keep the earliest candidate —
    which is floor-greedy's own choice, so the policy never does worse than
    greedy *on the probed objective*.
    """

    name = "ledger"
    deferred = True

    def __init__(self, max_victims: int = 3,
                 limit_fracs: tuple[float, ...] = (1.0, 0.85, 0.7),
                 objective=slo_weighted_stall):
        self.max_victims = max_victims
        self.limit_fracs = tuple(limit_fracs)
        self.objective = objective
        self.probes = 0          # candidate suffixes re-simulated
        self.staged = 0          # renegotiations actually staged
        self.decision_log: list[dict] = []

    # ------------------------------------------------------------ candidates
    def candidates(self, engine, head, needed, victims):
        """Feasible (victim, new_limit, decisions, new_floor, solve_ms)
        tuples in probe order: greedy's own pick is always first."""
        out = []
        seen = set()
        for v in victims[: self.max_victims]:
            base_limit = v.floor - needed
            if base_limit <= 0:
                continue
            for frac in self.limit_fracs:
                new_limit = int(base_limit * frac)
                if new_limit <= 0:
                    continue
                decisions, solve_ms = engine._replan(v.tenant, new_limit)
                new_floor = planned_peak(v.trace, decisions)
                if new_floor > new_limit:
                    continue  # solver could not push the floor low enough
                if v.floor - new_floor < needed:
                    continue  # shrink frees fewer bytes than the head needs
                key = (v.name, new_floor)
                if key in seen:
                    continue  # deeper frac solved to the same floor
                seen.add(key)
                out.append((v, new_limit, decisions, new_floor, solve_ms))
        return out

    # ---------------------------------------------------------------- probes
    def probe(self, engine, candidate):
        """Stage ``candidate`` on a fresh clone, resume the suffix, score it.

        Returns ``(score, report)``.  The clone is pristine per candidate —
        no staged state leaks between probes or back into the live engine.
        """
        v, new_limit, decisions, new_floor, _solve_ms = candidate
        clone = engine._probe_clone()
        run = next(r for r in clone._running if r.name == v.name)
        # Stage exactly as _stage_victim would (solve_ms 0: wall clock is
        # not simulated state and the objective never reads it).
        run.replan_pending = (list(decisions), new_floor, 0.0)
        clone._promised[run.device] = (
            clone._promised.get(run.device, 0) + run.floor - new_floor
        )
        self.probes += 1
        report = clone.resume()
        return self.objective(report), report

    # ---------------------------------------------------------------- choose
    def choose(self, engine, head, needed, victims):
        cands = self.candidates(engine, head, needed, victims)
        if not cands:
            return None
        best = best_report = None
        best_score = None
        for cand in cands:
            score, report = self.probe(engine, cand)
            if best_score is None or score < best_score:
                best, best_score, best_report = cand, score, report
        if best_score == float("inf"):
            return None  # every candidate future is infeasible
        attr = best_report.attribution or {}
        self.decision_log.append({
            "t": engine._now,
            "head": head.name,
            "needed": needed,
            "candidates": len(cands),
            "victim": best[0].name,
            "new_limit": best[1],
            "score": best_score,
            "binding_constraint": binding_constraint(attr),
        })
        self.staged += 1
        return best
