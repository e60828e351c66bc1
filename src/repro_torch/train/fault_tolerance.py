"""Fault tolerance for 1000+-node runs: retry/restart policy, straggler
monitoring, elastic re-mesh planning.  The port's own copy of
``repro.train.fault_tolerance`` (pure Python, no framework).

On a real cluster, node failure surfaces as a collective timeout / runtime
error inside the step; the policy here is the standard one:

    failure -> checkpoint-restore restart, excluding the bad host
            -> re-mesh onto the surviving device count (elastic)
            -> replay from the last checkpoint (bitwise, since data order
               is keyed by step)

This module implements the pieces that are testable without hardware: the
retry wrapper, the EWMA straggler detector, and the elastic mesh planner
(which factorizations survive losing k hosts).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class RetryPolicy:
    max_restarts: int = 3
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    retryable: Tuple[type, ...] = (RuntimeError, OSError)


def run_with_restarts(
    step_fn: Callable[[], None],
    restore_fn: Callable[[], None],
    policy: RetryPolicy,
    sleep=time.sleep,
) -> int:
    """Drive ``step_fn`` with restart-on-failure.  Returns restart count."""
    restarts = 0
    backoff = policy.backoff_s
    while True:
        try:
            step_fn()
            return restarts
        except policy.retryable:
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            sleep(backoff)
            backoff *= policy.backoff_mult
            restore_fn()


class StragglerMonitor:
    """Per-step wall-time EWMA + variance; flags steps beyond k sigma.

    On a pod a straggling host shows up as a slow step for EVERYONE
    (collectives synchronize), so the monitor runs on the coordinator and
    the report carries which host's input pipeline lagged (per-host
    timestamps, when available)."""

    def __init__(self, alpha: float = 0.1, k_sigma: float = 4.0, warmup: int = 8):
        self.alpha = alpha
        self.k = k_sigma
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.flagged: List[Tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        if self.n > self.warmup:
            sigma = math.sqrt(max(self.var, 1e-12))
            if dt > self.mean + self.k * sigma and dt > 1.5 * self.mean:
                is_straggler = True
                self.flagged.append((step, dt))
        # EWMA update (straggler steps excluded so the mean stays clean)
        if not is_straggler:
            delta = dt - self.mean
            self.mean += self.alpha * delta
            self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return is_straggler


def elastic_mesh_plan(
    n_devices: int,
    model_parallel: int,
    devices_per_host: int = 4,
) -> Dict[str, int]:
    """Largest (data, model) factorization that fits ``n_devices`` while
    keeping the TP degree — the re-mesh used after excluding failed hosts.

    TP groups must not span failed hosts, so data-parallel replicas drop in
    units of whole TP groups."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_devices} devices"
        )
    data = n_devices // model_parallel
    return {
        "data": data,
        "model": model_parallel,
        "used_devices": data * model_parallel,
        "idle_devices": n_devices - data * model_parallel,
    }


@dataclasses.dataclass
class HeartbeatTracker:
    """Host liveness from periodic heartbeats (coordinator side)."""

    timeout_s: float = 60.0
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host_id: int, now: float) -> None:
        self.last_seen[host_id] = now

    def dead_hosts(self, now: float) -> List[int]:
        return [
            h for h, t in self.last_seen.items() if now - t > self.timeout_s
        ]
