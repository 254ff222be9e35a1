"""The trainer's data pipeline and checkpoints on the CPU: ``batch_at`` and
``DataLoader`` against the JAX package's bit for bit (the pipeline is numpy
on both sides); the checkpoint round trip (bfloat16 leaves restored bit for
bit), an uncommitted checkpoint ignored, the last ``keep`` kept; the
carbon-aware trainer's hourly budgets against the reference gate; and the
trainer killed at step 8 and resumed in subprocesses
(``python -m repro_torch.launch.train --device cpu`` with only
``PYTHONPATH=src``), bit for bit against the uninterrupted run (in this
process, one thread as in the subprocesses, while the first subprocess
runs) in every leaf of the final checkpoint.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import DataLoader as JDataLoader
from repro.data import batch_at as jbatch_at
from repro.launch.train import CarbonGate as JCarbonGate
from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, DataLoader, batch_at
from repro_torch.launch.train import train

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread (the test workers share the
    cores; more threads only wait on each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 4, 0),
                                                  (151936, 256, 3, 7)])
def test_batch_at_matches_reference(vocab, seq, batch, seed):
    for step in (0, 1, 17, 1000):
        want = jbatch_at(JDataConfig(vocab, seq, batch, seed), step)
        got = batch_at(DataConfig(vocab, seq, batch, seed), step)
        assert got.keys() == want.keys()
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_data_loader_matches_reference():
    """Two hosts tile the global batch; prefetched steps in order, from a
    start step; extra inputs as the reference draws them."""
    extra = {"frames": ((3, 2), np.float32)}
    for host in (0, 1):
        kw = dict(host_index=host, host_count=2, start_step=5,
                  extra_specs=extra)
        jl = JDataLoader(JDataConfig(512, 32, 8, 3), **kw)
        tl = DataLoader(DataConfig(512, 32, 8, 3), **kw)
        try:
            for _ in range(3):
                (js, jb), (ts, tb) = next(jl), next(tl)
                assert js == ts and tb.keys() == jb.keys()
                for k in jb:
                    np.testing.assert_array_equal(tb[k], jb[k])
        finally:
            jl.close()
            tl.close()
    # host 1 of 2 holds rows 4..7 of the global batch
    full = batch_at(DataConfig(512, 32, 8, 3), ts)["tokens"]
    np.testing.assert_array_equal(tb["tokens"], full[4:])


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": torch.randn(6, 4, generator=g).bfloat16(),
                       "stack.0.ln": torch.randn(4, generator=g)},
            "opt": {"m": {"embed": torch.randn(6, 4, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree, out=None):
    out = [] if out is None else out
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            _leaves(tree[k], out)
        else:
            out.append(tree[k])
    return out


def test_save_restore_roundtrip(tmp_path):
    """Every leaf back with its type, bfloat16 bit for bit; the layout on
    disk is the reference's (manifest, arrays/<i>.npy, COMMIT); a restore
    onto zeros of the same structure, and onto a map_location."""
    tree = _tree()
    assert ckpt.save(tmp_path, 7, tree, async_=True).join(30) is None
    assert ckpt.latest_step(tmp_path) == 7
    d = tmp_path / "step_00000007"
    assert (d / "COMMIT").read_text() == "ok"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 7 and len(manifest["leaves"]) == 4
    keys = [leaf["key"] for leaf in manifest["leaves"]]
    assert keys == ["opt/m/embed", "opt/step", "params/embed",
                    "params/stack.0.ln"]                # sorted key paths
    assert np.load(d / "arrays" / "2.npy").dtype == np.uint16   # bf16 bits
    zeros = {"params": {k: torch.zeros_like(v) for k, v in
                        tree["params"].items()},
             "opt": {"m": {"embed": torch.zeros(6, 4)},
                     "step": torch.tensor(0, dtype=torch.int32)}}
    out = ckpt.restore(tmp_path, 7, zeros, map_location="cpu")
    for a, b in zip(_leaves(out), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(tmp_path, 7, {"params": zeros["params"]})


def test_uncommitted_checkpoint_ignored(tmp_path):
    tree = {"a": torch.zeros(2)}
    ckpt.save(tmp_path, 1, tree)
    ckpt.save(tmp_path, 2, tree)
    os.remove(tmp_path / "step_00000002" / "COMMIT")   # a crash mid-write
    assert ckpt.latest_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, 2, tree)


def test_gc_keeps_last_k(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in range(6):
        ckpt.save(tmp_path, s, tree, keep=3)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004", "step_00000005"]


TRAIN = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "12", "--batch", "2",
         "--seq", "32", "--ckpt-every", "5", "--log-every", "5",
         "--carbon-aware", "--steps-per-hour", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The smoke trainer of ``TRAIN``: ``python -m repro_torch.launch.train``
    hard-killed at step 8 (after the step-5 checkpoint) in a subprocess,
    and meanwhile the uninterrupted run to step 12 in this process
    (``train``, what the CLI calls); then the relaunch, which resumes. The
    uninterrupted result, both checkpoint directories and the two
    subprocesses' results."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    d, dk = (tmp_path_factory.mktemp(n) for n in ("uninterrupted", "killed"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN,
           "--ckpt-dir", str(dk)]
    killed = subprocess.Popen(cmd + ["--kill-at-step", "8"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
    try:
        res = train("qwen3-0.6b", smoke=True, steps=12, batch=2, seq=32,
                    ckpt_dir=str(d), ckpt_every=5, log_every=5,
                    carbon_aware=True, steps_per_hour=3, device="cpu")
        _, err = killed.communicate(timeout=300)
    finally:
        killed.kill()
    step_at_kill = ckpt.latest_step(dk)
    resumed = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=300)
    return dict(res=res, dir=d, killed_dir=dk, step_at_kill=step_at_kill,
                killed=(killed.returncode, err), resumed=resumed)


def test_carbon_aware_budgets_follow_the_reference_gate(runs):
    """``--carbon-aware``: each hour's step budget is the reference gate's
    ``steps_for_hour``; the steps run are their sum up to ``steps``."""
    res = runs["res"]
    gate = JCarbonGate()
    want = []
    while sum(want) < 12:
        want.append(gate.steps_for_hour(len(want), 3))
    assert res.budgets == want and res.step == 12
    assert len(res.step_losses) == 12 and np.isfinite(res.step_losses).all()
    assert res.losses == res.step_losses[4::5]


def test_kill_and_resume_trainer(runs):
    """The run killed at step 8 exits 42 with the step-5 checkpoint last;
    the relaunch resumes from step 5 and ends on the same state, every
    leaf of the step-12 checkpoint bit for bit, as the uninterrupted run."""
    code, err = runs["killed"]
    assert code == 42, err[-2000:]
    assert runs["step_at_kill"] == 5
    rb = runs["resumed"]
    assert rb.returncode == 0, rb.stderr[-2000:]
    assert "resumed from step 5" in rb.stdout
    assert ckpt.latest_step(runs["killed_dir"]) == 12
    da = runs["killed_dir"] / "step_00000012" / "arrays"
    db = runs["dir"] / "step_00000012" / "arrays"
    names = sorted(p.name for p in db.iterdir())
    assert names == sorted(p.name for p in da.iterdir()) and len(names) > 3
    for name in names:
        a, b = np.load(da / name), np.load(db / name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
