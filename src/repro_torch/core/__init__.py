"""Daisy core in PyTorch: query-driven denial-constraint cleaning.

Public API re-exports (the slices ported so far: SP, group-by and join
queries with FD and DC rules, and the offline baseline).
"""

from repro_torch.core.accuracy import Accuracy, repair_accuracy
from repro_torch.core.constraints import DC, FD, Atom, fd_as_dc, overlaps_query
from repro_torch.core.cost import CostModel
from repro_torch.core.detect import DetectResult, detect_auto, detect_dc, detect_fd
from repro_torch.core.executor import Daisy, DaisyConfig, DaisyResult
from repro_torch.core.ledger import StripLedger, WorkLedger
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
from repro_torch.core.relation import Dictionary, Relation, make_relation
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
    "JoinClause",
    "JoinState",
    "OfflineCleaner",
    "Pred",
    "Query",
    "Relation",
    "StripLedger",
    "WorkLedger",
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
