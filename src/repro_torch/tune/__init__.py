"""repro_torch.tune — ledger-guided runtime tuning.

Counterpart of ``repro/tune/__init__.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_colocate.py``
holds the two equal.

Closes the simulate -> attribute -> decide loop: the engine's barrier
snapshots + ``resume()`` make candidate futures cheap to simulate,
and the stall-attribution ledger scores them by *named cause*.
Three tuners consume that machinery:

  * ``LedgerVictimPolicy`` — renegotiation victim selection by simulated
    marginal SLO-weighted stall (``MemoryRuntime(victim_policy=...)``);
  * ``tuned_shares`` — coordinate-descent colocation budget splits
    (``colocate_programs(budget_split="tuned")``);
  * ``lane_split_from_waits`` — directional HostLink lane carving from a
    probe run's per-direction queue wait
    (``dist.run_mesh(lane_split="directional")``).

Every default stays untouched: with no tuner engaged, reports remain
bit-identical to the frozen ``runtime/_engine_reference.py``.
"""

from .budget import BudgetSplitResult, tuned_shares
from .lanes import lane_split_from_waits
from .objective import binding_constraint, slo_weighted_stall
from .victim import LedgerVictimPolicy

__all__ = [
    "BudgetSplitResult",
    "LedgerVictimPolicy",
    "binding_constraint",
    "lane_split_from_waits",
    "slo_weighted_stall",
    "tuned_shares",
]
