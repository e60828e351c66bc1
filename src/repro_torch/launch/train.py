"""The port's training launcher: the cleaning data pipeline feeding the train
loop (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --reduced \\
        --steps 5 --device cpu

Every batch is a Daisy query over the corpus's dirty metadata
(``data.pipeline.default_pipeline``), cleaned on the pipeline's device; the
step is ``train.steps.make_train_step`` with the config's optimizer.  It runs
on the card unless ``--device cpu`` is given.  ``--units`` keeps that many
pattern units of the config (the depth cut of a full-width run that does
not fit the card at full depth); ``--warmup-steps`` sets the learning
rate's warmup, which the reference fixes at 100 steps.

Fault tolerance: every ``--ckpt-every`` steps a checkpoint lands under
``--ckpt-dir`` (atomic, the reference's layout); on start the latest one is
restored.  The resumed run replays the pipeline's first batch requests
(their queries clean the metadata, and their draws advance the sampler), so
it trains on the batches an uninterrupted run would have seen from that
step on: a resumed step is the same computation as the uninterrupted one.
Step times feed the straggler monitor.

``train(opts)`` runs the loop and returns the per-step metrics with the
final state, so tests and ``chip_smoke.py`` drive the code ``main`` runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.relation import resolve_device
from repro_torch.data.pipeline import PipelineConfig, default_pipeline
from repro_torch.models.params import init_params
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.fault_tolerance import StragglerMonitor
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.steps import make_train_step


@dataclasses.dataclass
class TrainOptions:
    """The launcher's arguments (``main``'s flags, same names)."""

    arch: str = "qwen3-4b"
    reduced: bool = False
    steps: int = 100
    batch_docs: int = 8
    seq: int = 128
    lr: float = 3e-4
    warmup_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    n_docs: int = 1024
    seed: int = 0
    device: str = "cuda"
    units: Optional[int] = None


@dataclasses.dataclass
class TrainRun:
    """What ``train`` leaves behind: one metrics dict per step run
    (``step`` 0-based, ``loss``, ``grad_norm``, ``lr``, ``seconds``,
    ``straggler``), the final parameters and optimizer state, the step
    restored from (0 without a checkpoint), the pipeline and the config."""

    metrics: List[Dict]
    params: Dict
    opt_state: Dict
    start: int
    pipe: object
    cfg: object


def prepare(opts: TrainOptions):
    """(cfg, pipeline, workload, params) of ``opts``: the config cut to
    ``units``, the corpus pipeline and the seeded master parameters, on
    ``opts.device``."""
    dev = resolve_device(opts.device)
    cfg = get_config(opts.arch, reduced=opts.reduced).canonicalize(tp=1)
    if opts.units is not None:
        cfg = dataclasses.replace(cfg, n_layers=opts.units * len(cfg.pattern))
    pipe_cfg = PipelineConfig(
        batch_docs=opts.batch_docs, seq_len=opts.seq,
        vocab_size=min(cfg.vocab_size, 1024), seed=opts.seed,
    )
    pipe, workload = default_pipeline(opts.n_docs, pipe_cfg, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(opts.seed), dev)
    return cfg, pipe, workload, params


def train(opts: TrainOptions, on_step: Optional[Callable] = None, log=print) -> TrainRun:
    """Run the loop of ``opts``.  ``on_step(step, params, opt_state,
    metrics)`` is called after each step."""
    cfg, pipe, workload, params = prepare(opts)
    opt_cfg = OptConfig(name=cfg.optimizer, lr=opts.lr, warmup_steps=opts.warmup_steps,
                        total_steps=opts.steps)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=1, mamba_chunk=32)

    start = 0
    if opts.ckpt_dir and latest_step(opts.ckpt_dir) is not None:
        state, start = restore_checkpoint(opts.ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        log(f"restored checkpoint at step {start}")

    batches = pipe.batches(workload, opts.steps)
    for _ in range(start):  # replay the requests the checkpointed steps made
        next(batches)
    monitor = StragglerMonitor()
    metrics: List[Dict] = []
    t_start = time.time()
    for step, batch in enumerate(batches, start=start):
        t0 = time.perf_counter()
        params, opt_state, out = step_fn(params, opt_state, batch)
        row = {"step": step, **{k: float(v) for k, v in out.items()}}  # waits for the step
        dt = row["seconds"] = time.perf_counter() - t0
        row["straggler"] = monitor.record(step, dt)
        metrics.append(row)
        if row["straggler"]:
            log(f"[straggler] step {step} took {dt:.2f}s (mean {monitor.mean:.2f}s)")
        if step % 10 == 0:
            log(f"step {step:4d} loss {row['loss']:.4f} "
                f"({dt:.2f}s/step, clean={pipe.cleaning_progress()})")
        if on_step is not None:
            on_step(step, params, opt_state, row)
        if opts.ckpt_dir and opts.ckpt_every and (step + 1) % opts.ckpt_every == 0:
            path = save_checkpoint(
                opts.ckpt_dir, step + 1,
                {"params": params, "opt": opt_state, "extra": {"arch": cfg.name}},
            )
            log(f"checkpointed -> {path}")
    log(f"done: {opts.steps - start} steps in {time.time() - t_start:.1f}s; "
        f"cleaning progress {pipe.cleaning_progress()}")
    return TrainRun(metrics, params, opt_state, start, pipe, cfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-docs", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=100,
                    help="linear warmup steps of the learning rate (the reference's 100)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--n-docs", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the pipeline's Daisy run (cuda or cpu)")
    ap.add_argument("--units", type=int, default=None,
                    help="keep this many pattern units of the config (the depth cut)")
    args = ap.parse_args(argv)
    train(TrainOptions(**{f.name: getattr(args, f.name)
                          for f in dataclasses.fields(TrainOptions)}))


if __name__ == "__main__":
    main()
