"""repro_torch.service — the port's own copy of ``repro.service``, over
the port's ``Daisy``: concurrent query serving over the gradually-cleaned
probabilistic instance (DESIGN.md §9), with cost-model-driven background
cleaning behind the serving loop (§10).

The paper's engine cleans *on demand*, driven by the queries users perform;
this package is the layer that takes a stream of analytical queries from
many sessions and shares one Daisy instance — and the cleaning work —
between them:

* ``server``     continuous-batching step loop (after serve/engine.py)
                 over a thread-safe submission queue;
* ``scheduler``  tickets + rule/cluster batching so one clean_sigma pass
                 pays for a whole batch of overlapping-σ queries, and the
                 ``rule_deps`` dependency sets the cache versions against;
* ``cache``      clean-state-aware result cache keyed on (query
                 fingerprint, per-scope version vector);
* ``session``    per-user identity, lineage, and admission limits;
* ``metrics``    queries/sec, cache effectiveness, detect/repair work
                 amortized per query, foreground/background attribution;
* ``background`` the ``BackgroundCleaner``: full-cleans cold rule scopes
                 between serving steps so interactive queries stop paying
                 even the first-touch detect;
* ``qos``        traffic shaping (DESIGN.md §14): SLO classes, the
                 weighted-fair submit queue with its starvation bound,
                 and the overload policy that sheds to tagged-stale
                 cached answers instead of queueing.

Sharing is sound because candidate-overlay merges are commutative and
associative (Lemma 4, core/update.py) and the executor's checked-bit
bookkeeping makes re-cleaning a no-op — concurrent sessions converge on
one clean state, and equal version vectors over a query's dependency
scopes guarantee bit-identical answers.  A concurrent background cleaner
only accelerates that convergence (DESIGN.md §10).
"""

from repro_torch.service.background import BackgroundCleaner, IncrementReport
from repro_torch.service.cache import ResultCache
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.qos import (
    DEFAULT_SLO_CLASSES,
    FairQueue,
    QoSPolicy,
    SLOClass,
    vector_staleness,
)
from repro_torch.service.scheduler import Ticket, batch_tickets, cluster_key, rule_deps
from repro_torch.service.server import QueryServer
from repro_torch.service.session import LineageEntry, Session, SessionLimitError

__all__ = [
    "BackgroundCleaner",
    "DEFAULT_SLO_CLASSES",
    "FairQueue",
    "IncrementReport",
    "LineageEntry",
    "QoSPolicy",
    "QueryServer",
    "ResultCache",
    "SLOClass",
    "ServiceMetrics",
    "Session",
    "SessionLimitError",
    "Ticket",
    "batch_tickets",
    "cluster_key",
    "rule_deps",
    "vector_staleness",
]
