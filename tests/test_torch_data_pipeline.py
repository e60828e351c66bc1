"""The port's cleaning data pipeline against ``repro.data.pipeline``, and the
port's training launcher on the CPU.

The same corpus metadata (``token_metadata_relation``, numpy on both sides)
goes through both pipelines: each batch request is a Daisy query that
cleans the metadata, and the sampler draws documents and tokens in numpy.
The doc ids each request returns, the token batches and
``cleaning_progress`` must be equal bit for bit, before and after an
``ingest_docs`` append, in both qualify modes.  The launcher's loop
(``launch.train.train``, what ``python -m repro_torch.launch.train`` runs)
is held to a resumed run: restored from its checkpoint, it replays the
pipeline's first requests and takes the uninterrupted run's last step
exactly."""

import dataclasses
import gc

import jax
import numpy as np
import pytest
import torch

from repro.core.operators import Pred as JPred
from repro.data import pipeline as jpipe
from repro.data.generators import token_metadata_relation as jax_token_metadata
from repro_torch.core.operators import Pred
from repro_torch.data import pipeline as tpipe
from repro_torch.data.generators import token_metadata_relation
from repro_torch.launch import train as tlaunch
from repro_torch.train.optim import tree_items

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _free_compiled():
    """Drop JAX's compiled executables when this file's tests end: XLA's CPU
    backend keeps each one mapped in memory for the life of the process."""
    yield
    jax.clear_caches()
    gc.collect()


N_DOCS = 512


def test_token_metadata_matches_reference():
    for n, seed in ((N_DOCS, 5), (64, 9)):
        got, want = token_metadata_relation(n, seed=seed), jax_token_metadata(n, seed=seed)
        for part in ("data", "truth"):
            a, b = getattr(got, part), getattr(want, part)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (part, k)
        assert np.array_equal(got.error_rows, want.error_rows)


def new_docs(start, n=64, seed=9):
    data = {k: v.copy() for k, v in token_metadata_relation(n, seed=seed).data.items()}
    data["doc_id"] = data["doc_id"] + np.int32(start)
    return data


@pytest.mark.parametrize("qualify", ["threshold", "sample"])
def test_pipeline_matches_reference_bit_for_bit(qualify):
    cfg = dict(batch_docs=4, seq_len=32, vocab_size=1024, qualify=qualify, seed=3)
    jp, jwork = jpipe.default_pipeline(N_DOCS, jpipe.PipelineConfig(**cfg))
    tp, twork = tpipe.default_pipeline(N_DOCS, tpipe.PipelineConfig(**cfg), device="cpu")
    assert [[dataclasses.astuple(p) for p in w] for w in twork] == \
        [[dataclasses.astuple(p) for p in w] for w in jwork]
    # four requests: two languages, a narrower quality filter, an empty one
    for preds in ([("language", "==", 3), ("quality", ">=", 0.25)],
                  [("language", "==", 7)],
                  [("language", "==", 3), ("quality", ">=", 0.9)],
                  [("language", "==", 99)]):
        got = tp.request([Pred(*p) for p in preds])
        want = jp.request([JPred(*p) for p in preds])
        assert got.dtype == want.dtype and np.array_equal(got, want), preds
        assert tp.cleaning_progress() == jp.cleaning_progress()
    treport = tp.ingest_docs(new_docs(N_DOCS))
    jreport = jp.ingest_docs(new_docs(N_DOCS))
    for field in ("rows", "start", "capacity_before", "capacity", "grown"):
        assert getattr(treport, field) == getattr(jreport, field), field
    for tb, jb in zip(tp.batches(twork, 5), jp.batches(jwork, 5)):
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int32 and tb[key].device.type == "cpu"
            assert np.array_equal(tb[key].numpy(), np.asarray(jb[key])), key
    assert tp.cleaning_progress() == jp.cleaning_progress()
    assert tp.queries_run == jp.queries_run == 9


def test_launcher_resumes_from_its_checkpoint(tmp_path):
    """Three steps uninterrupted against two, a checkpoint, and a resumed
    third: the third step's loss, grad norm and parameters are the same
    bits."""
    opts = tlaunch.TrainOptions(arch="qwen3-4b", reduced=True, steps=3, batch_docs=2, seq=16,
                                n_docs=256, device="cpu", lr=1e-3)
    logs = []
    full = tlaunch.train(opts, log=logs.append)
    assert [m["step"] for m in full.metrics] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) for m in full.metrics)
    ckpt = str(tmp_path / "ckpt")
    first = tlaunch.train(dataclasses.replace(opts, steps=2, ckpt_dir=ckpt, ckpt_every=2),
                          log=logs.append)
    assert first.metrics == [dict(m, seconds=f["seconds"]) for m, f in
                             zip(full.metrics[:2], first.metrics)]
    resumed = tlaunch.train(dataclasses.replace(opts, ckpt_dir=ckpt, ckpt_every=2),
                            log=logs.append)
    assert resumed.start == 2 and [m["step"] for m in resumed.metrics] == [2]
    for key in ("loss", "grad_norm", "lr"):
        assert resumed.metrics[0][key] == full.metrics[2][key], key
    for (path, a), (_, b) in zip(tree_items(resumed.params), tree_items(full.params)):
        assert torch.equal(a, b), path
    assert any(line.startswith("restored checkpoint at step 2") for line in logs)


def test_launcher_main_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps", "2", "--batch-docs", "2",
                  "--seq", "16", "--n-docs", "128", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "done: 2 steps" in out
