"""Batched serving engine: continuous batching over fixed decode slots.

The counterpart of ``repro.serve.engine``, with its semantics.  The engine
owns a slot table of ``max_batch`` concurrent sequences sharing one KV
cache (slot = batch index).  Requests join free slots; every engine step
runs ONE decode for all active slots; finished sequences (EOS or max_len)
free their slot.  Prompts enter token by token through decode.  The cache
is a preallocated (slots, S_max) region in float32 by default.

Per-slot state is host-side bookkeeping; device state is the cache, of
any registered architecture (``init_cache``: KV blocks, int8 under
``kv_quant``, Mamba states, and whisper's cross cache, which stays zero:
the engine runs no encoder, as in the reference).  A slot that takes a new
request keeps the Mamba state and the cache rows its last occupant left,
as in the reference.  The parameters are cast to their compute copy once,
when the engine is made.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.relation import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import cast_params
from repro_torch.models.transformer import decode_step, init_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (p,) int32
    max_new: int = 32
    eos: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_batch: int = 8,
        max_seq: int = 512,
        cache_dtype=torch.float32,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = cast_params(params, cfg)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.cache = init_cache(cfg, max_batch, max_seq, cache_dtype, device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pending: List[Request] = []
        self._tokens = np.zeros((max_batch, 1), np.int32)
        self._pos = np.zeros(max_batch, np.int32)  # per-slot sequence length

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _admit(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and self.pending:
                req = self.pending.pop(0)
                self.slots[i] = req
                # prompt enters token by token (prefill by decode)
                self._tokens[i, 0] = req.prompt[0]
                self._pos[i] = 0
                req._consumed = 1
                req._prompt_len = len(req.prompt)

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """One decode across all slots; returns #active slots."""
        self._admit()
        active = [i for i in range(self.max_batch) if self.slots[i] is not None]
        if not active:
            return 0
        # NOTE: slots share one cache['t']; per-slot positions are tracked
        # on the host and the shared t advances uniformly, as in the
        # reference.  Sequences therefore align their cache writes; empty
        # slots decode garbage that is never read.
        tokens = torch.from_numpy(self._tokens).to(self.device)
        logits, self.cache = decode_step(self.params, self.cfg, self.cache, tokens)
        logits = logits.cpu().numpy()
        for i in active:
            req = self.slots[i]
            nxt_pos = int(self._pos[i]) + 1
            if req._consumed < req._prompt_len:
                # still feeding the prompt
                self._tokens[i, 0] = req.prompt[req._consumed]
                req._consumed += 1
            else:
                tok = int(np.argmax(logits[i]))
                req.out.append(tok)
                self._tokens[i, 0] = tok
                if (req.eos is not None and tok == req.eos) or len(
                    req.out
                ) >= req.max_new:
                    req.done = True
                    self.slots[i] = None
            self._pos[i] = nxt_pos
            if nxt_pos >= self.max_seq - 1 and self.slots[i] is not None:
                self.slots[i].done = True
                self.slots[i] = None
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.pending or any(s is not None for s in self.slots)) and (
            steps < max_steps
        ):
            self.step()
            steps += 1
