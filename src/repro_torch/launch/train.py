"""Trainer: checkpoint and restart, deterministic batch replay, optional
carbon-aware (VCC-gated) step pacing, optional int8 gradient compression.
The counterpart of ``repro.launch.train``.

The trainer is the fleet's canonical flexible workload: with
``--carbon-aware`` it takes each hour's step budget from a VCC-derived
hourly capacity gate (``CarbonGate``) and so shifts its steps toward clean
hours, the workload-side view of the paper's mechanism (the cluster-side
shaping lives in ``repro_torch.core``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 200 --ckpt-dir /tmp/ck --carbon-aware --device cpu

Fault tolerance: kill it at any point; relaunching with the same flags
resumes from the last committed checkpoint and replays the exact batch
stream (``repro_torch.data``). Runs on ``cuda`` unless ``--device cpu``
is given (and raises without a card). ``train(...)`` is the same loop as a
function: it returns the losses and the timings.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import device as device_mod
from repro_torch.configs import get_arch
from repro_torch.core import carbon, prng
from repro_torch.data import DataConfig, batch_at
from repro_torch.models import build_model
from repro_torch.models.model import stub_inputs
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step


class CarbonGate:
    """Hourly capacity of a one-cluster VCC over one simulated grid day:
    the inverse of the hour's carbon intensity, normalised to a mean of 1
    (the day's budget is kept). The grid day comes from the port's threefry
    stream, which is bitwise the reference's."""

    def __init__(self, seed: int = 0):
        zone = carbon.default_zones(1)[0]
        intensity = carbon.simulate_zone_from(
            prng.PRNGKey(seed), carbon.zone_params(zone), 1)[0]
        self.intensity = intensity.numpy()
        inv = 1.0 / np.clip(self.intensity, 1e-3, None)
        self.capacity = inv / inv.mean()

    def steps_for_hour(self, hour: int, base: int) -> int:
        """The trainer's step budget in ``hour`` (hour % 24 of the day)."""
        return max(0, int(round(base * self.capacity[hour % 24])))

    def admitted(self, round_: int, batch: int) -> int:
        """Requests the server admits in round ``round_`` (hour r % 24)."""
        return max(1, int(round(batch * min(self.capacity[round_ % 24],
                                            1.5))))


class TrainResult(NamedTuple):
    step: int                     # the step the run ended at
    losses: List[float]           # the loss every log_every steps
    step_losses: List[float]      # every step's loss this run
    step_ms: List[float]          # every step's wall time (synchronised)
    budgets: List[int]            # each hour's step budget this run


def train(arch: str = "qwen3-0.6b", *, smoke: bool = False,
          steps: int = 200, batch: int = 8, seq: int = 256,
          ckpt_dir: str = "", ckpt_every: int = 50,
          carbon_aware: bool = False, steps_per_hour: int = 20,
          compress: bool = False, kill_at_step: int = -1,
          step_deadline_s: float = 0.0, lr: float = 3e-3,
          log_every: int = 10, device=None, model=None) -> TrainResult:
    """Train for ``steps`` steps on ``batch_at(DataConfig(vocab, seq,
    batch), step)`` with the reference trainer's AdamW (warmup 20, decay
    over max(steps, 100)), resuming from ``ckpt_dir``'s last committed
    checkpoint. ``model`` (already on ``device``) replaces the one built
    from ``arch`` with weights from seed 0. A VLM's and an
    encoder-decoder's batches get their stub frontends' zeros
    (``models.stub_inputs``). ``kill_at_step`` ends the process with code
    42 right after that step (fault injection)."""
    dev = device_mod.resolve(device)
    if model is None:
        a = get_arch(arch)
        cfg = (a.smoke if smoke else a.config).replace(remat="none")
        model = build_model(cfg, dev, seed=0)
    cfg = model.cfg
    opt_cfg = AdamWConfig(peak_lr=lr, warmup_steps=20,
                          decay_steps=max(steps, 100))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    state = init_train_state(model, opt_cfg, compress=compress)
    step_fn = make_train_step(model, opt_cfg, compress=compress)

    def tree():
        return {"params": model.state_dict(), "opt": state["opt"]}

    start = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            restored = ckpt.restore(ckpt_dir, last, tree())
            with torch.no_grad():
                for k, p in model.state_dict().items():
                    p.copy_(restored["params"][k])
            state["opt"] = restored["opt"]
            start = last
            print(f"[train] resumed from step {start}")

    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    gate = CarbonGate() if carbon_aware else None
    step = start
    hour = start // max(steps_per_hour, 1)
    losses, step_losses, step_ms, budgets = [], [], [], []
    t0 = time.perf_counter()
    while step < steps:
        budget = (gate.steps_for_hour(hour, steps_per_hour) if gate
                  else steps_per_hour)
        budgets.append(budget)
        if gate is not None:
            print(f"[train] hour={hour % 24:02d} carbon="
                  f"{gate.intensity[hour % 24]:.3f} budget={budget} steps")
        for _ in range(budget):
            if step >= steps:
                break
            tokens = batch_at(dcfg, step)["tokens"]
            inputs = {"tokens": torch.tensor(tokens, dtype=torch.int64,
                                             device=dev),
                      **stub_inputs(cfg, batch, dev)}
            ts = now()
            state, metrics = step_fn(state, inputs)
            step_ms.append(1e3 * (now() - ts))
            step_losses.append(float(metrics["loss"]))
            if step_deadline_s and step > start + 1 \
                    and step_ms[-1] > 1e3 * step_deadline_s:
                print(f"[train] STRAGGLER step={step + 1} took "
                      f"{step_ms[-1] / 1e3:.2f}s "
                      f"(deadline {step_deadline_s}s)")
            step += 1
            if step == kill_at_step:
                print(f"[train] fault injection: dying at step {step}",
                      flush=True)
                os._exit(42)
            if step % log_every == 0:
                losses.append(step_losses[-1])
                rate = (step - start) / (time.perf_counter() - t0)
                extra = (f" hour={hour % 24:02d} budget={budget}"
                         if gate else "")
                print(f"[train] step={step} loss={losses[-1]:.4f} "
                      f"steps/s={rate:.2f}{extra}")
            if ckpt_dir and step % ckpt_every == 0:
                ckpt.save(ckpt_dir, step, tree(), async_=False)
        hour += 1
    if ckpt_dir:
        ckpt.save(ckpt_dir, step, tree())
    print(f"[train] done at step {step}; final loss "
          f"{step_losses[-1] if step_losses else float('nan'):.4f}")
    return TrainResult(step, losses, step_losses, step_ms, budgets)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--carbon-aware", action="store_true")
    ap.add_argument("--steps-per-hour", type=int, default=20)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--kill-at-step", type=int, default=-1,
                    help="fault injection: hard-exit at this step")
    ap.add_argument("--step-deadline-s", type=float, default=0.0,
                    help="straggler mitigation: steps exceeding this wall "
                         "time are logged as straggler events (the "
                         "deterministic pipeline makes a replay safe)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, carbon_aware=args.carbon_aware,
                steps_per_hour=args.steps_per_hour, compress=args.compress,
                kill_at_step=args.kill_at_step,
                step_deadline_s=args.step_deadline_s, lr=args.lr,
                log_every=args.log_every, device=args.device)
    return res.losses


if __name__ == "__main__":
    main()
