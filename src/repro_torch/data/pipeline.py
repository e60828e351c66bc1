"""CleanDataPipeline: the paper's technique woven into LM training (the
counterpart of ``repro.data.pipeline``).

Every training step's batch request is a QUERY over the (dirty) document
metadata relation ("docs with language == L and quality >= q"), and Daisy's
cleaning operators run inside that query's plan: the answer is relaxed,
violations of the metadata rules (FD source -> language) are repaired
probabilistically, and the repairs persist.  The corpus cleans itself
incrementally, driven by what training samples.

The relation and the port's ``Daisy`` live on the pipeline's ``device`` (the
card by default), so the cleaning runs there.  The sampling stays on the
host, in numpy, with the reference's generator and draws, so both packages
pick the same documents and the same tokens; a batch's ``tokens`` and
``labels`` are int32 tensors on the pipeline's device.  A doc qualifies with
the probability mass of its qualifying candidates; ``threshold`` mode keeps
the query's answer as it is.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.constraints import FD
from repro_torch.core.executor import Daisy, DaisyConfig, IngestReport
from repro_torch.core.operators import Pred, Query
from repro_torch.core.relation import make_relation, resolve_device
from repro_torch.data.generators import DirtyDataset, token_metadata_relation


@dataclasses.dataclass
class PipelineConfig:
    batch_docs: int = 32
    seq_len: int = 256
    vocab_size: int = 1024
    qualify: str = "threshold"  # 'threshold' | 'sample'
    tau: float = 0.5
    k: int = 8
    seed: int = 0


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class CleanDataPipeline:
    """Query-driven, incrementally-cleaning batch source."""

    def __init__(
        self,
        meta: DirtyDataset,
        rules: Sequence[FD],
        cfg: PipelineConfig,
        device="cuda",
    ):
        self.cfg = cfg
        self.meta = meta
        self.device = resolve_device(device)
        n = len(meta.data["doc_id"])
        rel = make_relation(
            meta.data,
            overlay=[a for r in rules for a in r.attrs],
            k=cfg.k,
            rules=[r.name for r in rules],
            device=self.device,
        )
        self.daisy = Daisy(
            {"docs": rel}, {"docs": list(rules)},
            DaisyConfig(k=cfg.k, use_cost_model=True, expected_queries=64),
            device=self.device,
        )
        self.rng = np.random.default_rng(cfg.seed)
        # deterministic synthetic tokens per doc (hash-seeded)
        self._doc_seed = np.arange(n, dtype=np.int64) * 2654435761 % (2**31)
        self.queries_run = 0
        self.reports: List = []

    # --------------------------------------------------------------- queries
    def request(self, preds: Sequence[Pred]) -> np.ndarray:
        """Run one cleaned metadata query; returns qualifying doc ids."""
        q = Query("docs", preds=tuple(preds), project=("doc_id",))
        res = self.daisy.execute(q)
        self.queries_run += 1
        self.reports.append(res.report)
        rel = self.daisy.db["docs"]
        mask = _host(res.mask)

        if self.cfg.qualify == "threshold":
            keep = mask
        else:  # sample each doc by its qualifying probability mass
            probs = self._qualify_mass(rel, preds)
            keep = mask & (self.rng.random(len(mask)) < probs)
        return _host(rel.columns["doc_id"])[keep]

    def _qualify_mass(self, rel, preds) -> np.ndarray:
        mass = np.ones(rel.capacity, np.float32)
        for p in preds:
            if p.col in rel.cand:
                probs = _host(rel.probs(p.col))
                vals = _host(rel.cand[p.col])
                ok = _np_op(vals, p.op, p.value)
                has = probs.sum(axis=1) > 0
                base = _np_op(_host(rel.columns[p.col]), p.op, p.value)
                mass *= np.where(has, (probs * ok).sum(axis=1), base.astype(np.float32))
            else:
                mass *= _np_op(_host(rel.columns[p.col]), p.op, p.value)
        return mass

    # --------------------------------------------------------------- streaming
    def ingest_docs(self, data: Mapping[str, np.ndarray]) -> IngestReport:
        """Append a chunk of new docs into the live metadata relation
        through ``Daisy.ingest`` (DESIGN.md §12): the rows arrive dirty and
        cold, later batch requests clean them on demand like the seed
        corpus, and rows already checked absorb the newcomers' evidence
        through the queued ingest-deltas.  Per-doc token seeds extend
        deterministically, so a doc's synthetic tokens are the same whether
        it arrived in the seed corpus or mid-training."""
        report = self.daisy.ingest("docs", data)
        max_id = int(np.max(np.asarray(data["doc_id"]))) + 1 if report.rows else 0
        if max_id > len(self._doc_seed):
            ids = np.arange(len(self._doc_seed), max_id, dtype=np.int64)
            self._doc_seed = np.concatenate(
                [self._doc_seed, ids * 2654435761 % (2**31)]
            )
        return report

    def stream_corpus(
        self, chunks: Iterable[Mapping[str, np.ndarray]]
    ) -> Iterator[IngestReport]:
        """Chunked streaming-ingest source: feed corpus growth through the
        pipeline one chunk at a time, yielding each chunk's
        ``IngestReport``."""
        for chunk in chunks:
            yield self.ingest_docs(chunk)

    # ---------------------------------------------------------------- batches
    def batches(
        self, workload: Sequence[Sequence[Pred]], steps: int
    ) -> Iterator[Dict[str, torch.Tensor]]:
        """Cycle the query workload, yielding token batches."""
        for i in range(steps):
            preds = workload[i % len(workload)]
            docs = self.request(preds)
            if len(docs) == 0:
                docs = np.asarray(self.meta.data["doc_id"][:1])
            pick = self.rng.choice(docs, self.cfg.batch_docs, replace=True)
            yield self._tokens_for(pick)

    def _tokens_for(self, doc_ids: np.ndarray) -> Dict[str, torch.Tensor]:
        b, s = self.cfg.batch_docs, self.cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        for i, d in enumerate(doc_ids):
            r = np.random.default_rng(self._doc_seed[int(d)])
            toks[i] = r.integers(0, self.cfg.vocab_size, s + 1)
        toks = torch.from_numpy(toks).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # -------------------------------------------------------------- metrics
    def cleaning_progress(self) -> Dict[str, float]:
        rel = self.daisy.db["docs"]
        total = float(rel.num_rows())
        checked = {}
        for rule in self.daisy.rules["docs"]:
            c = rel.checked.get(rule.name)
            checked[rule.name] = (0.0 if c is None else float(c.sum())) / total
        return checked


def _np_op(x, op, v):
    return {
        "==": operator.eq, "!=": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge,
    }[op](x, v)


def default_pipeline(
    n_docs: int = 2048, cfg: Optional[PipelineConfig] = None, device="cuda"
) -> Tuple[CleanDataPipeline, List[List[Pred]]]:
    """The standard corpus + per-language query workload."""
    cfg = cfg or PipelineConfig()
    meta = token_metadata_relation(n_docs)
    rules = [FD("src_lang", "source", "language")]
    pipe = CleanDataPipeline(meta, rules, cfg, device=device)
    workload = [
        [Pred("language", "==", lang), Pred("quality", ">=", 0.25)]
        for lang in range(16)
    ]
    return pipe, workload
