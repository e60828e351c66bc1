"""Daisy core in PyTorch: query-driven denial-constraint cleaning.

Public API re-exports (the slices ported so far: SP, group-by and join
queries with FD and DC rules, the offline baseline, streaming ingest,
background increments and sharded detection on a ``dist.hints.Mesh``).
"""

from repro_torch.core.accuracy import Accuracy, repair_accuracy
from repro_torch.core.constraints import DC, FD, Atom, fd_as_dc, overlaps_query
from repro_torch.core.cost import CostModel
from repro_torch.core.detect import DetectResult, detect_auto, detect_dc, detect_fd
from repro_torch.core.executor import Daisy, DaisyConfig, DaisyResult, IngestReport
from repro_torch.core.ledger import (
    TABLE_ROWS_RULE,
    PendingIngest,
    StripLedger,
    WorkLedger,
)
from repro_torch.core.offline import OfflineCleaner
from repro_torch.core.operators import (
    GroupBySpec,
    JoinClause,
    JoinState,
    Pred,
    Query,
    filter_mask,
)
from repro_torch.core.planner import plan_query
from repro_torch.core.relation import Dictionary, Relation, append_rows, make_relation
from repro_torch.core.relax import relax_fd
from repro_torch.core.repair import repaired_value
from repro_torch.core.update import apply_candidates, mark_checked, unchecked

__all__ = [
    "Accuracy",
    "Atom",
    "CostModel",
    "DC",
    "Daisy",
    "DaisyConfig",
    "DaisyResult",
    "DetectResult",
    "Dictionary",
    "FD",
    "GroupBySpec",
    "IngestReport",
    "JoinClause",
    "JoinState",
    "OfflineCleaner",
    "PendingIngest",
    "Pred",
    "Query",
    "Relation",
    "StripLedger",
    "TABLE_ROWS_RULE",
    "WorkLedger",
    "append_rows",
    "apply_candidates",
    "detect_auto",
    "detect_dc",
    "detect_fd",
    "fd_as_dc",
    "filter_mask",
    "make_relation",
    "mark_checked",
    "overlaps_query",
    "plan_query",
    "relax_fd",
    "repair_accuracy",
    "repaired_value",
    "unchecked",
]
