"""The paper's offline comparison baseline (§7 "our own offline
implementation") in PyTorch, the counterpart of ``repro.core.offline``.

Full-dataset cleaning before any query arrives:

* FD error detection: the sort-based group-by ``detect_fd`` over the WHOLE
  relation;
* DC error detection: the same fused pair scan as Daisy's, over the full
  matrix (one launch of the CUDA kernel on the card);
* data repairing: candidate values for an erroneous rhs are the rhs values
  of tuples sharing its lhs (the group-distinct candidate table),
  probabilistic output.

After ``clean_all`` the database is fully probabilistic; ``execute`` runs
queries through a Daisy executor whose cleaning steps no-op on the fully
checked relations.  For FDs, Daisy's incremental answers equal these
(§1 contribution 1).  The cleaner works on the device its relations live on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from repro_torch.core.constraints import DC, FD
from repro_torch.core.detect import detect_dc, detect_fd
from repro_torch.core.executor import Daisy, DaisyConfig, DaisyResult
from repro_torch.core.operators import Query
from repro_torch.core.relation import Relation
from repro_torch.core.repair import dc_repair_candidates, fd_repair_candidates
from repro_torch.core.update import apply_candidates, mark_checked


class OfflineCleaner:
    """Clean everything up front, then answer queries."""

    def __init__(
        self,
        db: Dict[str, Relation],
        rules: Dict[str, Sequence[FD | DC]],
        config: DaisyConfig | None = None,
    ):
        self.config = config or DaisyConfig()
        self.rules = {t: list(rs) for t, rs in rules.items()}
        self.db = dict(db)
        self._engine: Daisy | None = None

    def clean_all(self) -> None:
        for table, rules in self.rules.items():
            rel = self.db[table]
            for rule in rules:
                if isinstance(rule, FD):
                    det = detect_fd(rel, rule, rel.valid, k=self.config.k)
                    deltas = fd_repair_candidates(rel, rule, det, rel.valid)
                else:
                    det = detect_dc(
                        rel, rule, rel.valid, rel.valid, block=self.config.dc_block
                    )
                    deltas = dc_repair_candidates(rel, rule, det, rel.valid, k=self.config.k)
                rel = apply_candidates(rel, deltas)
                rel = mark_checked(rel, rule.name, rel.valid)
            self.db[table] = rel

    def execute(self, query: Query) -> DaisyResult:
        if self._engine is None:
            # rules kept (for join re-checks) but everything is checked, so
            # cleaning steps no-op; no cost model and no statistics scan
            cfg = dataclasses.replace(self.config, use_cost_model=False,
                                      collect_stats=False)
            device = next(iter(self.db.values())).device
            self._engine = Daisy(self.db, self.rules, cfg, device=device)
        result = self._engine.execute(query)
        self.db = self._engine.db
        return result
