#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--gla-parent DIR]

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: ``nvcc`` compiles the nine kernel sources of the port (three
   of kernel #4: its decode, bf16 prefill and float32 prefill routes;
   three of #5: its scalar-decay and per-channel-decay tensor-core routes
   and its CUDA-core route) from
   their ``csrc/`` into ``build/`` (one compiler process per source, all
   started together, with ``-Xptxas -v``: registers and spills);
3. kernels against their plain versions on the card, at three row counts
   each (ragged, the path's, fleet scale): the PGD epoch (#1) and the CVaR
   ensemble epoch (#2, K = 8 and 32) at iters = 80, one joint step (#3,
   its split route's step alone); then #3 with the shift update against
   ``ref.joint_step_s_arrays`` at the slice path's 28 x 512 on its fused
   route (one launch, a thread-block cluster a rollout; the blocks of a
   cluster must agree on nu bit for bit) and its split route (two
   launches; d' bitwise the fused route's), at 4 x 3,000 clusters,
   where the wrapper takes the split route, and at the 8 rollouts of 8
   clusters of ``examples_torch/scenario_sweep.py --spatial``, with the residuals and box
   violations of d' and s'; and the split route's ``s_project`` alone.
   Max error, conservation residual, bound violations, kernel and plain
   times (CUDA events, median of 20 after warm-up; fewer for the slowest
   plain runs), the least time the card could take for the same work and
   the shuffle-issue floor of each kernel's layout (#1 and #2: row groups
   of ``kernel.LANES`` lanes); and #2 over identical members against #1. Then flash attention (#4) at
   the serving path's prefill and decode shapes of Zamba2-7B,
   Qwen3-0.6B and DeepSeekMoE-16B (16 heads of 128; its decode in float32
   too), InternVL2-2B (its 1,280 positions of vision prefix and prompt)
   and Whisper-base (8 heads of 64: the encoder's non-causal 1,500 x
   1,500, the decoder's non-causal cross-attention over 1,500 frames in
   prefill and in decode with no cache length, in bf16 and float32),
   DeepSeek-V2-236B's MLA prefill (128 heads at head dim 192, v's last 64
   columns zero as the model pads them, and the output's exact zeros
   there; in bf16 and float32), a
   ragged length, and GQA, window and softcap cases, the float32 prefill
   route's own cases (B * N = 65,536, H = 256 with window and softcap at a
   ragged 1,000 tokens, a chunked prefill, GQA, H = 33), Yi-6B's and
   DeepSeek-67B's prefill and decode (8 query heads a KV head), Gemma2-9B's
   served prefill over 4,608 tokens and a decode step past position 4,096
   on a local layer (window 4,096) and a global one (the 1 << 30
   sentinel), softcap 50, the decode steps in float32 too, timed
   beside ``scaled_dot_product_attention`` (under a softcap beside
   ``flex_attention`` compiled), the windowed bf16 prefills held row by
   row at the window's edge against a window one key off, with each
   call's route (and
   key splits for decode), TFLOP/s and share of the bound (for the float32
   prefill route also its split-TF32 ceiling); at the seven
   bf16 serving calls, how the route rounds P (against the reference and
   against float32 attention, the TPU kernel's arithmetic); the decode
   route's float32 split partials against ``ref.attention_partials``;
   and the GLA scan (#5) at
   Zamba2-7B's Mamba2 prefill (a ragged length and an initial state too)
   and in RWKV6-7B's per-channel and bonus + strict modes (at a batch of
   2, at decays of -30 a step and more, at a ragged 1,000 tokens, and at
   its serving prefill's 4 x 1,024 tokens), each line naming its route;
   at the serving prefill's shape the split-TF32 source ``gla_scan.cu``
   timed too, on the same inputs, beside the route's time; and that
   route's own cases (RWKV6-7B in float32 at 2 x 1,024 from a state, the
   same at decays of -30 a step, odd widths K = 24, V = 40 over 1,000
   tokens, a bf16 scalar decay with the bonus in the strict mode, a float32
   token from a state) with their split-TF32 ceilings; ``--gla-parent DIR``
   times an earlier ``gla_scan.cu`` (the parent commit's) in turns with
   each of them;
4. main path: ``sim.rollout_batch`` over ``default_library(7)`` x seeds 0-3
   for 7 days at 512 clusters, 64 campuses, 16 zones on the card, with the
   kernel launch counts, finiteness, and conservation and bounds of every
   day's solution checked; then one more day under ``torch.profiler``
   (device busy share, top ops; full table in chiprun_out/);
4b. the same batch through ``sim.rollout_batch_sharded`` with the default
   devices (every card: one) and as two shards on cuda:0: state, ledger
   and traj bit for bit the main path's, 140 launches of #1 a shard; and
   ``forecast.calibrate_half_lives`` on three clusters' 35-day history of
   the main path's burned-in state, on the card against the CPU (the same
   pair, the 6 x 6 MAPE surface within 1e-5 relative);
5. slice path, the risk-aware joint day: ``SimConfig(joint_spatial=True,
   n_members=8)`` over ``mobility_sweep_library(7) + risk_sweep_library(7)``
   x seeds 0-3 (28 rollouts) for 7 days at the same fleet size, with exact
   launch counts of all three kernels (every joint step one launch on
   #3's fused route; no ``s_project`` launch and no eager projection on
   the card), the same daily checks at the shifted budgets, the
   rollout-days on which the joint solve kept its joint point, the
   scenario table and the sweep rows (the mobility rows against the same
   batch under ``joint_spatial=False``, counted apart), a joint step's
   host time on the fused and the split route and, off the path, the
   eager projection's, and one profiled day with its launch count;
5b. closed-loop path, the paper's day re-planned each hour:
   ``SimConfig(streaming=True)`` (the open loop) and then
   ``SimConfig(streaming=True, mpc=True)`` (the closed loop) over
   ``forecast_bust_library(7)`` x seeds 0-3 (12 rollouts, 6,144 rows) for
   7 days at the same fleet size, with exact launches of #1 (140 and 476:
   20 day-solve epochs a day, and 48 suffix epochs with mpc) and none of
   #2-#5; every day finite values, the queue conserved over the horizon,
   the enforced curve's hour 0 the gated plan's and the day solve's
   conservation and bounds; the recourse table, the share of cluster-hours
   on which the enforced curve left the plan, the per-rollout state bytes
   against the rescan state's, a closed-loop day's wall time and its
   24-hour loop's share, #1 at the closed loop's suffix boxes of hours 1,
   12, 23 and 24 against its plain version (pinned entries bit for bit)
   with one suffix epoch timed, and one profiled closed-loop day;
5c. repeat and telemetry: the main, slice and closed-loop paths again from
   each one's burned-in state with ``telemetry=False`` and with
   ``telemetry=True``, under PyTorch's default algorithms (the campus sums
   of ``solver.segment_sum`` add in a fixed order): the telemetry-off run
   bit for bit the path's first run (two runs of the same rollout agree),
   telemetry on and off bit for bit in states, ledgers and traj, the same
   launches of #1-#3; the record checked on
   the card (finite, the gauges' ranges, ``joint_winner`` the day's
   ``StepOut.best.take``, the recourse gauges ``StepOut.recourse``), its
   trace written to ``chiprun_out/telemetry_<path>.jsonl`` and read back,
   the per-scenario table, the CVaR tail in [1/8, 1] on the slice path;
   each path's day with and without telemetry (median of 3 rollouts) and
   the launches it adds to a profiled day; ``profile_stages`` (one day's
   spans) on the main and closed-loop states, ``profile_setup`` (the
   burn-in's and a warm-up day's spans) on the closed-loop path's
   fleets; then ``core.fleet`` at 512 clusters:
   ``init_fleet`` and two ``day_cycle``s against the engine's burn-in and
   day steps of the same fleet, bit for bit (20 launches of #1 a day);
6. serving path, carbon-aware serving at full published width in bf16
   (random weights from a seed): ``launch.serve.serve`` of Zamba2-7B,
   Qwen3-0.6B, RWKV6-7B, DeepSeekMoE-16B, InternVL2-2B (after its 256
   zero vision embeddings), Whisper-base (prompts of 128 tokens on
   1,500 zero frames), DeepSeek-V2-236B (8 of its 60 layers: the
   dense first layer and 7 MoE layers), Yi-6B, Gemma2-9B (prompts of
   4,608 tokens: its 4,096-key window binds on its 21 local layers in the
   prefill and at every decode step; how many queries and positions it
   cuts printed) and DeepSeek-67B (32 of its 95 layers), 2 rounds of 4
   prompts of 1,024 tokens and 32 decoded tokens each, with exact launch
   counts of #4
   and #5 (and their calls by route: RWKV6's 64 scans all on ``gla_vec``;
   DeepSeekMoE's 56 prefill and 1,792 decode calls of #4, InternVL2's 48
   and 1,536, Whisper's 36 and 768, DeepSeek-V2's 16 and none: its
   absorbed decode over the latent cache is plain torch), prefill and
   per-token times, tokens/s and peak memory; a full-width check of a
   decode step's logits against the prefill of the same tokens; one
   profiled Zamba2 prefill and one profiled RWKV6 prefill (the device's
   busy share and #5's share of it) and one profiled decode step of each,
   and of InternVL2, Whisper and Gemma2 with #4's share;
   for DeepSeekMoE and DeepSeek-V2 the share of routed assignments each
   round's prefill dropped at the published capacity factor of 1.25, the
   same prefill twice bit for bit, the decode check at a capacity factor
   of E / k rounded up (11 and 27: a slot for every token) with no
   assignment dropped, held in float32 (DeepSeekMoE at full depth,
   DeepSeek-V2 at its dense layer and one MoE layer: the absorbed decode
   against the expanded prefill; in bf16 held within 5e-2 only where no
   route flipped, since a flip moves it past that), on that float32 model one prefill through the scatter
   dispatch against the einsum dispatch, a profiled prefill and decode
   step with #4's share, and DeepSeek-V2's latent cache bytes;
6b. the trainer on the card (``launch.train.train``, bf16, random weights
   from a seed, the reference trainer's batch 8, sequence 256, lr 3e-3 and
   warmup 20): Qwen3-0.6B at full published width for 20 steps with the
   carbon gate on (each hour's step budget printed), a finite loss every
   step and the mean of the last 3 below the first, exactly 28 launches of
   #4 a step on its ``flash_prefill`` route and none of #5, steps/s,
   tokens/s, peak memory and the share of the bf16 peak from 6 N T; the
   autograd Functions of #4 (at a Qwen3 attention layer's training shape)
   and #5 (at Zamba2-7B's Mamba2 training shape), their forward the kernel
   and backward the plain version's autograd, against the plain route:
   output within 2e-2, each input's gradient within 2e-2 of its largest
   |value| (and whether bit for bit), forward + backward timed each way;
   a Qwen3 step's forward, backward and update times and one profiled
   step (table in chiprun_out/profile_train_step.txt);
   Zamba2-7B at its published widths and 12 of 81 layers, RWKV6-7B at
   its published widths and 8 of 32 layers, and DeepSeekMoE-16B at its
   published widths and 4 of 28 layers (its aux loss finite each step),
   DeepSeek-V2-236B at its published widths and 1 of 60 layers (its
   dense first layer with its MLA mixer),
   InternVL2-2B and Whisper-base at full width and depth (the stub's zero
   frames in each batch, seeded vision embeddings in place of the stub's
   zeros, whose gradients overflow at 24 layers),
   Yi-6B at 8 of 32 layers, Gemma2-9B at 4 of 42 and DeepSeek-67B at 1
   of 95 at their published widths,
   for 2 steps each, with exact launches of #4 and #5 (RWKV6's on
   ``gla_vec``; its step's parts and a profiled step after them), and
   #5's Function at RWKV6's training shape (bonus, strict) and #4's at
   Whisper's cross-attention (non-causal, 255 queries on 1,500 frames)
   and at Gemma2's local layer (1 x 4,608, window 4,096, softcap 50)
   against the plain route, each #4 case timed in turns with the
   library's forward + backward (SDPA, or compiled flex_attention under
   a softcap) and beside the bound of a forward + backward; and
   ``python -m repro_torch.launch.train
   --smoke`` killed at step 17 and resumed to 30 in subprocesses, every
   leaf of the final checkpoint against an uninterrupted run (bit for bit,
   or within 1e-5);
6c. the five examples of ``examples_torch/`` in-process on the card, the
   counts at 0 before each: quickstart, fleet_week, serve_shaped,
   train_carbon_aware and scenario_sweep's default mode at the originals'
   defaults, its --risk, --spatial, --telemetry --trace and --sharded at 3
   days and 2 seeds; exact launches of #1 to #5 (#3's and #4's by route),
   finite output, the trace read back, Fig 12's counts the numpy draws,
   the loss falling; #4 at serve_shaped's prefill and decode calls and at
   train_carbon_aware's float32 call against its plain version and SDPA,
   its Function's forward + backward beside SDPA's (#3 at the --spatial sweep's 8 x 8 is held in phase 3); Fig 12 on the
   card against the CPU; each example's wall seconds;
7. the golden configuration, the slice configuration at golden size and
   the streaming closed loop (``streaming=True, mpc=True``) at golden size
   over ``forecast_bust_library(3)``, on the card (kernels) against the
   CPU (plain versions), within the parity tests' end-to-end tolerances;
   the golden and closed-loop runs with ``telemetry=True``, their trace
   records within the classes of tests/test_torch_telemetry_rollout.py;
   at golden size the slice's best-of
   verdicts must agree on both devices and keep the joint point somewhere;
   and the serving smoke configs (Zamba2, Qwen3, RWKV6, DeepSeekMoE,
   InternVL2, Whisper, DeepSeek-V2, Yi-6B, Gemma2-9B and DeepSeek-67B) in
   float32, cuda against cpu (logits of 40-token prompts' prefill and 4
   decode steps, greedy tokens; #5's calls by route, all on ``gla_scan``;
   Gemma2's smoke window of 16 binds in both);
8. one ``{"kernels": [...]}`` JSON line (#4's launches by path and model,
   its times at every case and its Function's forward + backward beside
   the library's and the bound (``autograd_by_case``), #5's launches by path,
   model and
   route among their keys (``serve_golden``'s float32 calls too) and its
   times at every case in ``by_case`` (on ``gla_scan`` with the split-TF32
   ceiling, and the parent's time given ``--gla-parent``); its RWKV6 route
   ``gla_vec`` also as a record of its own, with ``gla_scan.cu``'s time
   beside it), the ``nvidia-smi``
   line, and last
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one, and without the repo's
``src/`` beside it.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
BF16_TENSOR_PER_S = 989e12           # H100 SXM dense bf16 tensor rate
TF32_TENSOR_PER_S = 495e12           # H100 SXM dense TF32 tensor rate
KERNEL_TOL = 1e-4                    # max |kernel - plain| on delta
JOINT_TOL = 1e-5                     # one joint step: d', and x max|g_s|
SHIFT_TOL = 1e-5                     # s': x max|z|, plus the bracket width
IDENTICAL_TOL = 1e-6                 # #2 over identical members vs #1
ITERS = 80
# the main path: default_library's 11 scenarios x 4 seeds x 512 clusters
MAIN_DAYS = 7
MAIN_SEEDS = (0, 1, 2, 3)
MAIN_CLUSTERS = 512
MAIN_ROWS = 11 * len(MAIN_SEEDS) * MAIN_CLUSTERS
KERNEL_ROWS = (1000, MAIN_ROWS, 131072)  # ragged, main path, fleet scale
# the slice path: 4 mobility + 3 risk scenarios x 4 seeds x 512 clusters
SLICE_MEMBERS = 8
SLICE_ROLLOUTS = 7 * len(MAIN_SEEDS)
SLICE_ROWS = SLICE_ROLLOUTS * MAIN_CLUSTERS
SLICE_KERNEL_ROWS = (1000, SLICE_ROWS, 131072)
# (rollouts, clusters) past one thread-block cluster's rows: #3's split route
SPLIT_SHAPE = (4, 3000)
# (rollouts, clusters) of examples_torch/scenario_sweep.py --spatial at the
# [examples] phase's arguments: 4 mobility scenarios x 2 seeds of its 8
# clusters, a cluster of one block (its 4 zones are no operand of #3)
SPATIAL_EXAMPLE_SHAPE = (4 * 2, 8)
# each path's configuration, params, burned-in state and telemetry-off
# results, kept by its phase for the telemetry phase's re-runs
RUNS = {}


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# a ~2 ms spin on the stream ahead of a timed kernel: the host enqueues the
# launch while the card spins, so the events time the kernel's device work
# and not the wrapper's Python (which a short kernel would otherwise wait on)
LEAD_CYCLES = 4_000_000


def cuda_ms(fn, reps: int = 20, warmup: int = 2, lead: bool = False
            ) -> float:
    """Median milliseconds of ``fn()`` on the current stream, between two
    CUDA events; ``lead=True`` puts ``LEAD_CYCLES`` of spin before the
    start event."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(LEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ phase 1 + 2

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"[device] {name}; nvidia-smi: {smi('name,power.limit')}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"SMs {props.multi_processor_count}; max SM clock {clock_mhz} MHz; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return name, props.multi_processor_count, clock_mhz


def kernel_builds():
    """(name, build function) of every kernel source of the port."""
    from functools import partial

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    return [(k, partial(pgd_kernel.build, k)) for k in pgd_kernel.SOURCES] \
        + [(k, partial(fa_kernel.build, k)) for k in fa_kernel.SOURCES] \
        + [(k, partial(gla_kernel.build, k)) for k in gla_kernel.SOURCES]


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    todo = kernel_builds()
    with ThreadPoolExecutor(len(todo)) as pool:
        futs = {k: pool.submit(fn, verbose=True) for k, fn in todo}
        results = {k: f.result() for k, f in futs.items()}
    for k, (path, secs, log) in results.items():
        print(f"[build] {k}: {path.relative_to(ROOT)} in {secs:.2f} s")
        for line in log.strip().splitlines():
            print(f"[build]   {line}")
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)


# ------------------------------------------------------------------ phase 3

def random_rows(rows: int, seed: int, device, H: int = 24):
    """A bounded PGD epoch problem in the kernel's layout: every seventh
    row has its box collapsed to {0}, as the solver does for infeasible
    clusters."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    eta = 0.1 + 0.6 * u(rows, H)
    pi = 150.0 + 250.0 * u(rows, H)
    pow_nom = 300.0 + 400.0 * u(rows, H)
    tau24 = 0.05 + 0.3 * u(rows, 1)
    price = 0.05 + 0.5 * u(rows, 1)
    lambda_e = 0.02 + 2.0 * u(rows, 1)
    lo = torch.full((rows, H), -0.8)
    ub = 0.1 + 2.9 * u(rows, H)
    dead = torch.arange(rows)[:, None] % 7 == 0
    lo = torch.where(dead, 0.0, lo)
    ub = torch.where(dead, 0.0, ub)
    temp = 0.02 * pow_nom.mean(-1, keepdim=True)
    lr = 0.5 / (pi.amax(-1, keepdim=True) * tau24
                * (lambda_e * eta.amax(-1, keepdim=True) + price))
    delta = torch.zeros(rows, H)
    args = [x.to(device).contiguous() for x in
            (delta, eta, pi, pow_nom, tau24, price, lo, ub, lr)]
    return args, temp.to(device), lambda_e.to(device)


class Card:
    """The card's rates for the bounds: FP32 peak (every SM issues 128
    FP32 lanes a clock, an FMA counting as two operations: 67 TFLOP/s on a
    132-SM H100 SXM at 1980 MHz), the HBM rate, and one warp shuffle per
    SM and clock (the issue floor of the PGD kernels' reductions)."""

    def __init__(self, sms, clock_mhz):
        self.sms = sms
        self.fp32_per_s = sms * 128 * 2 * clock_mhz * 1e6
        self.shfl_per_s = sms * clock_mhz * 1e6

    def bound(self, flops, nbytes, dtype=torch.float32):
        """The larger of the bytes over the HBM rate and the operations over
        the peak rate for ``dtype``: the bf16 tensor rate for bf16 data,
        the FP32 rate for float32."""
        rate = BF16_TENSOR_PER_S if dtype == torch.bfloat16 \
            else self.fp32_per_s
        ops_ms = 1e3 * flops / rate
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                       else "bytes"), ops_ms, bytes_ms


def report(name, rows, err, tol, resid, viol, ms, plain_ms, card, flops,
           nbytes, shuffles, extra=""):
    bound_ms, by, ops_ms, bytes_ms = card.bound(flops, nbytes)
    print(f"[kernel] {name} rows={rows}{extra}: max|kernel-plain|={err:.3e}"
          f" (limit {tol:g}), conservation max|sum_h d|={resid:.3e}, bound "
          f"violation {viol:.3e}; kernel {ms:.4f} ms (device), plain "
          f"{plain_ms:.4f} "
          f"ms; bound {bound_ms:.4f} ms by {by} (ops {flops:.4g} -> "
          f"{ops_ms:.4f} ms, bytes {nbytes:.4g} -> {bytes_ms:.4f} ms); the "
          f"design's shuffle-issue floor "
          f"{1e3 * shuffles / card.shfl_per_s:.4f} ms", flush=True)
    return bound_ms, by


def feasible_or_raise(name, rows, d, lo, ub, resid, viol):
    if not (resid <= 1e-4 * max(ub.abs().max().item(), 1.0)
            and viol <= 1e-6):
        raise AssertionError(f"{name} output infeasible at rows={rows}")


def conservation(d, lo, ub):
    resid = d.sum(-1).abs().max().item()
    viol = torch.clamp(torch.maximum(lo - d, d - ub), min=0.0).max().item()
    return resid, viol


def phase_kernels(card):
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    dev = torch.device("cuda")
    record = None
    for rows in KERNEL_ROWS:
        args, temp, lame = random_rows(rows, seed=rows, device=dev)

        def kern():
            return pgd_kernel.pgd_epoch_cuda(*args, temp, lame, iters=ITERS)

        def plain():
            return pgd_ref.pgd_epoch_ref(*args, temp=temp, lambda_e=lame,
                                         iters=ITERS)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        lo, ub = args[6], args[7]
        err = (got - want).abs().max().item()
        resid, viol = conservation(got, lo, ub)
        ms, plain_ms = cuda_ms(kern, lead=True), cuda_ms(plain)
        bound_ms, by = report(
            "vcc_pgd_epoch", rows, err, KERNEL_TOL, resid, viol, ms,
            plain_ms, card, pgd_kernel.epoch_flops(rows, 24, ITERS),
            pgd_kernel.epoch_bytes(rows, 24),
            pgd_kernel.epoch_shuffles(rows, ITERS))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with plain at rows={rows}")
        feasible_or_raise("vcc_pgd_epoch", rows, got, lo, ub, resid, viol)
        if rows == MAIN_ROWS:
            record = {"name": "vcc_pgd_epoch", "route": "cuda",
                      "source": "src/repro_torch/kernels/vcc_pgd/csrc/"
                                "pgd_epoch.cu",
                      "replaces": "src/repro/kernels/vcc_pgd/kernel.py:122",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": by,
                      "library_ms": None}
    return record


def random_members(rows, K, seed, device):
    """A CVaR epoch problem: ``random_rows`` plus K members of intensity
    (a whole-day profile each) and nominal power (member 0 the point
    forecast), stacked (B, K, n, H) as the slice path holds them: n = 512
    clusters a rollout where rows allow it, else one rollout of all rows;
    and the risk sharpness at beta = 0.5."""
    args, temp, lame = random_rows(rows, seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    H = args[0].shape[-1]
    prof = 1 + 0.4 * (torch.rand(K, 1, H, generator=g) - 0.5)
    prof[0] = 1.0
    noise = 30 * (torch.rand(K, rows, H, generator=g) - 0.5)
    noise[0] = 0.0
    n = MAIN_CLUSTERS if rows % MAIN_CLUSTERS == 0 else rows
    B = rows // n

    def stack(x):
        return x.reshape(K, B, n, H).transpose(0, 1).contiguous().to(device)

    eta_e, pow_e = stack(args[1][None] * prof), stack(args[3][None] + noise)
    risk_s = torch.full((rows, 1), 4.0, device=device)
    args = [x.to(device) for x in args]
    return args, eta_e, pow_e, temp.to(device), lame.to(device), risk_s, B


def phase_ens_kernel(card):
    """Kernel #2 against its plain version, at K = 8 (the slice path's) and
    K = 32 (the most the kernel takes); and over identical members against
    kernel #1."""
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    dev = torch.device("cuda")
    record = None
    for K in (SLICE_MEMBERS, 32):
        for rows in SLICE_KERNEL_ROWS:
            args, eta_e, pow_e, temp, lame, risk_s, B = random_members(
                rows, K, rows + K, dev)
            d, _, pi, _, tau24, price, lo, ub, lr = args

            def kern():
                return pgd_kernel.pgd_epoch_ens_cuda(
                    d, eta_e, pi, pow_e, tau24, price, lo, ub, lr, temp,
                    lame, risk_s, iters=ITERS)

            def b3(x):
                return x.reshape(B, rows // B, x.shape[-1])

            def plain():
                return pgd_ref.pgd_epoch_ens_ref(
                    b3(d), eta_e, b3(pi), pow_e, b3(tau24), b3(price),
                    b3(lo), b3(ub), b3(lr), temp=b3(temp),
                    lambda_e=b3(lame), risk_s=b3(risk_s),
                    iters=ITERS).reshape(rows, -1)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            resid, viol = conservation(got, lo, ub)
            ms = cuda_ms(kern, lead=True)
            plain_ms = cuda_ms(plain, reps=3 if rows > SLICE_ROWS else 10,
                               warmup=1)
            bound_ms, by = report(
                "vcc_pgd_epoch_ens", rows, err, KERNEL_TOL, resid, viol, ms,
                plain_ms, card,
                pgd_kernel.ens_epoch_flops(rows, 24, K, ITERS),
                pgd_kernel.ens_epoch_bytes(rows, 24, K),
                pgd_kernel.ens_epoch_shuffles(rows, K, ITERS),
                extra=f" K={K} (B={B})")
            if not err <= KERNEL_TOL:
                raise AssertionError(f"ensemble kernel disagrees with plain "
                                     f"at rows={rows}, K={K}")
            feasible_or_raise("vcc_pgd_epoch_ens", rows, got, lo, ub, resid,
                              viol)
            if rows == SLICE_ROWS and K == SLICE_MEMBERS:
                record = {"name": "vcc_pgd_epoch_ens", "route": "cuda",
                          "source": "src/repro_torch/kernels/vcc_pgd/csrc/"
                                    "pgd_epoch_ens.cu",
                          "replaces": "src/repro/kernels/vcc_pgd/"
                                      "kernel.py:251",
                          "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": by, "library_ms": None}
            del args, eta_e, pow_e, got, want
    # identical members collapse to kernel #1 (they share the device code)
    args, temp, lame = random_rows(SLICE_ROWS, 5, dev)
    d, eta, pi, pow_nom, tau24, price, lo, ub, lr = args
    for K in (1, SLICE_MEMBERS, 32):
        ens = pgd_kernel.pgd_epoch_ens_cuda(
            d, eta.expand(1, K, -1, -1).contiguous(), pi,
            pow_nom.expand(1, K, -1, -1).contiguous(), tau24, price, lo, ub, lr,
            temp, lame, torch.full_like(temp, 4.0), iters=ITERS)
        one = pgd_kernel.pgd_epoch_cuda(*args, temp, lame, iters=ITERS)
        torch.cuda.synchronize()
        gap = (ens - one).abs().max().item()
        print(f"[kernel] vcc_pgd_epoch_ens over {K} identical members vs "
              f"vcc_pgd_epoch, rows={SLICE_ROWS}: max gap {gap:.3e} "
              f"(limit {IDENTICAL_TOL:g}; bitwise: {bool(gap == 0.0)})",
              flush=True)
        if not gap <= IDENTICAL_TOL:
            raise AssertionError(f"identical members ({K}) differ from the "
                                 f"plain epoch by {gap:.3e}")
    return record


def random_joint(rows, seed, device, H: int = 24):
    """One joint step's operands: budgets tight enough that some rows are
    infeasible at tau + s, every fourth row's budget emptied by its
    shift."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    tau = 1.0 + 4.0 * u(rows, 1)
    s = tau * (u(rows, 1) - 0.5)
    s[::4] = -tau[::4]
    u_if, pi, eta = 0.3 + 0.3 * u(rows, H), 150 + 250 * u(rows, H), \
        0.1 + 0.6 * u(rows, H)
    price, lame = 0.05 + 0.5 * u(rows, 1), 0.02 + 2.0 * u(rows, 1)
    lr = 0.5 / (pi.amax(1, keepdim=True) * tau / 24
                * (lame * eta.amax(1, keepdim=True) + price))
    pow_nom = 300 + 400 * u(rows, H)
    args = [0.3 * (u(rows, H) - 0.5), s, eta, pi, pow_nom, tau, u_if,
            u_if * 1.1, 1.1 + 0.4 * u(rows, H), 0.75 + 0.25 * u(rows, 1),
            1.0 + 0.6 * u(rows, 1), price, lr,
            0.02 * pow_nom.mean(1, keepdim=True), lame]
    return [x.to(device).contiguous() for x in args]


def joint_box(args, drop):
    """The box of delta at tau + s, as ``core.vcc.delta_bounds`` gives it
    (infeasible rows collapse to {0})."""
    _, s, _, _, _, tau, u_if, u_if_q, ratio, upc, cap = args[:11]
    tau_s = tau + s
    t24 = torch.clamp(tau_s / 24.0, min=1e-9)
    ub = torch.clamp(torch.minimum((upc - u_if_q) / t24 - 1.0,
                                   (cap / ratio - u_if) / t24 - 1.0),
                     -drop, 24.0)
    feas = (ub.sum(-1, keepdim=True) >= 0.0) & (tau_s > 1e-6) \
        & (ub > -drop + 1e-9).all(-1, keepdim=True)
    return (torch.where(feas, torch.full_like(ub, -drop), 0.0),
            torch.where(feas, ub, 0.0))


def phase_joint_kernel(card, drop=0.8):
    """Kernel #3: the split route's step alone (d', g_s) against
    ``ref.joint_step_arrays`` at three row counts; then the step with the
    shift update (``phase_joint_s``). Returns the records of #3 and of the
    split route's shift update."""
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    dev = torch.device("cuda")
    split_ms = None
    for rows in SLICE_KERNEL_ROWS:
        args = random_joint(rows, rows, dev)

        def kern():
            return pgd_kernel.joint_step_cuda(*args, drop_limit=drop)

        def plain():
            return pgd_ref.joint_step_arrays(*args, drop_limit=drop)

        (d, g), (wd, wg) = kern(), plain()
        torch.cuda.synchronize()
        err = (d - wd).abs().max().item()
        g_scale = wg.abs().max().item()
        g_err = (g - wg).abs().max().item()
        lo, ub = joint_box(args, drop)
        resid, viol = conservation(d, lo, ub)
        ms, plain_ms = cuda_ms(kern, lead=True), cuda_ms(plain)
        host_ms = cuda_ms(kern)
        report(
            "vcc_joint_step (split route's step)", rows, err, JOINT_TOL,
            resid, viol, ms, plain_ms, card,
            pgd_kernel.joint_step_flops(rows, 24),
            pgd_kernel.joint_step_bytes(rows, 24),
            pgd_kernel.joint_step_shuffles(rows),
            extra=f" (g_s: max|kernel-plain|={g_err:.3e} of max|g_s| "
                  f"{g_scale:.3e}; rows with box {{0}}: "
                  f"{int((ub == 0).all(-1).sum())}; without the spin "
                  f"ahead, the events see the wrapper: {host_ms:.4f} ms)")
        if not (err <= JOINT_TOL and g_err <= JOINT_TOL * g_scale):
            raise AssertionError(f"joint step disagrees with plain at "
                                 f"rows={rows}")
        feasible_or_raise("vcc_joint_step", rows, d, lo, ub, resid, viol)
        if rows == SLICE_ROWS:
            split_ms = (ms, plain_ms)
    records = phase_joint_s(card, drop)
    records[0]["split_step_ms"], records[0]["split_step_plain_ms"] = split_ms
    return records


def random_joint_s(B, n, seed, device):
    """``random_joint``'s rows as B rollouts of n clusters, with the shift
    bounds at a mobility per rollout (the second at 0: lo_s = ub_s = 0)
    and lr_s per rollout: the operands of ``joint_step_s_cuda``."""
    g = torch.Generator().manual_seed(seed + 1)
    args = random_joint(B * n, seed, "cpu")
    tau = args[5]
    mob = 0.1 + 0.5 * torch.rand(B, 1, generator=g)
    mob[1] = 0.0
    mob = mob.repeat_interleave(n, 0)
    lr_s = 0.002 + 0.004 * torch.rand(B, 1, generator=g)
    return [x.to(device).contiguous()
            for x in (*args, -mob * tau, mob * tau, lr_s)]


def shift_check(label, B, n, s2, ws, z, width, lo_s, ub_s):
    """s' (B, n) against the plain version's ws (B, n): max error within
    SHIFT_TOL x max|z| plus the final bracket's width, inside its box, and
    conserving as closely as the plain version (both residuals are the
    rounding of sums over n clusters: twice the plain one plus n ulp of
    max|z|). Returns (error, limit, residual, plain residual, violation)."""
    z_scale = z.abs().max().item()
    err = (s2 - ws).abs().max().item()
    limit = SHIFT_TOL * z_scale + width
    resid = s2.sum(-1).abs().max().item()
    plain_resid = ws.sum(-1).abs().max().item()
    viol = torch.clamp(torch.maximum(lo_s - s2, s2 - ub_s), min=0.0
                       ).max().item()
    if not (err <= limit and viol == 0.0
            and resid <= 2 * plain_resid + n * 2 ** -24 * z_scale):
        raise AssertionError(f"{label}: s' error {err:.3e} (limit "
                             f"{limit:.3e}), residual {resid:.3e} (plain "
                             f"{plain_resid:.3e}), box violation {viol:.3e}")
    return err, limit, resid, plain_resid, viol


def phase_joint_s(card, drop=0.8):
    """Kernel #3 with the shift update against ``ref.joint_step_s_arrays``:
    at the slice path's 28 x 512 on the fused route (what the wrapper
    picks) and on the split route (the step's kernel, then ``s_project``),
    at 4 x 3,000 clusters, past one cluster's rows, where the wrapper
    takes the split route, and at the shape ``examples_torch/
    scenario_sweep.py --spatial`` gives it (``SPATIAL_EXAMPLE_SHAPE``, one
    block a cluster) on both routes. Each line: d' and s' against the plain version,
    the residuals and box violations of both, device ms against the bound
    and the plain version; the C blocks of each rollout's cluster must
    agree on nu bit for bit, and the routes on d'. Then ``s_project`` alone
    against ``ref.project_row``."""
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    dev = torch.device("cuda")
    record, ms_by_route = None, {}
    for B, n in ((SLICE_ROLLOUTS, MAIN_CLUSTERS), SPLIT_SHAPE,
                 SPATIAL_EXAMPLE_SHAPE):
        kern = random_joint_s(B, n, B * n, dev)
        rows = B * n
        pl = [x.reshape(B, n, x.shape[-1]) for x in kern[:-1]] + [kern[-1]]
        route, C, R = pgd_kernel.joint_plan(n)
        nu = {"wrapper": torch.empty(B * max(C, 1), 2, device=dev),
              "split": torch.empty(B, 2, device=dev)}

        def wrapper():
            return pgd_kernel.joint_step_s_cuda(*kern, n=n, drop_limit=drop,
                                                nu_out=nu["wrapper"])

        def split():
            d, g = pgd_kernel.joint_step_cuda(*kern[:15], drop_limit=drop)
            return d, pgd_kernel.s_project_cuda(
                kern[1], g, kern[17], kern[15], kern[16], n=n,
                nu_out=nu["split"])

        def plain():
            return pgd_ref.joint_step_s_arrays(*pl, drop_limit=drop)

        wd, ws = plain()
        _, wg = pgd_ref.joint_step_arrays(*pl[:15], drop_limit=drop)
        z = pl[1][..., 0] - pl[-1] * wg[..., 0]
        lo, ub = joint_box(kern, drop)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        runs = {route: wrapper} if route == "split" else \
            {"fused": wrapper, "split": split}
        outs = {}
        for name, fn in runs.items():
            d, s2 = fn()
            torch.cuda.synchronize()
            outs[name] = (d, s2)
            nus = nu["split" if fn is split else "wrapper"]
            width = nus[:, 1].max().item()
            err = (d - wd.reshape(rows, -1)).abs().max().item()
            if not err <= JOINT_TOL:
                raise AssertionError(f"joint step ({name}) disagrees with "
                                     f"plain at {B} x {n}: {err:.3e}")
            resid, viol = conservation(d, lo, ub)
            feasible_or_raise(f"vcc_joint_step ({name})", rows, d, lo, ub,
                              resid, viol)
            s_err, s_lim, s_res, s_pres, s_viol = shift_check(
                f"vcc_joint_step ({name}) at {B} x {n}", B, n,
                s2.reshape(B, n), ws[..., 0], z, width, pl[15][..., 0],
                pl[16][..., 0])
            agree = ""
            if name == "fused":
                bits = nus[:, 0].view(torch.int32).reshape(B, C)
                if not torch.equal(bits, bits[:, :1].expand(B, C)):
                    raise AssertionError("the blocks of a cluster found "
                                         "different nu")
                agree = (f"; the {C} blocks of each rollout's cluster agree "
                         "on nu bit for bit")
            ms = cuda_ms(fn, lead=True)
            shuffles = pgd_kernel.joint_step_s_shuffles(B, n) \
                if fn is wrapper else pgd_kernel.joint_step_shuffles(rows) \
                + pgd_kernel.shift_shuffles(B)
            plan = f"{C} blocks of {R} rows a rollout, one launch" \
                if name == "fused" else "the step's kernel, then s_project"
            flops = pgd_kernel.joint_step_s_flops(B, n, 24)
            nbytes = pgd_kernel.joint_step_s_bytes(B, n, 24)
            bound_ms = card.bound(flops, nbytes)[0]
            _, by = report(
                f"vcc_joint_step with the shift update, {name} route", rows,
                err, JOINT_TOL, resid, viol, ms, plain_ms, card, flops,
                nbytes, shuffles,
                extra=f" ({B} x {n}; {plan}; s': max|kernel-plain|="
                      f"{s_err:.3e} (limit {s_lim:.3e}, bracket width "
                      f"{width:.3e}), conservation max|sum_c s'|={s_res:.3e}"
                      f" (plain {s_pres:.3e}), box violation {s_viol:.3e}"
                      f"{agree}; bound share {100 * bound_ms / ms:.1f}%)")
            if (B, n) == SPATIAL_EXAMPLE_SHAPE and name == "fused":
                record["spatial_example"] = {
                    "shape": [B, n], "max_abs_err": err,
                    "s_max_abs_err": s_err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by}
            if n == MAIN_CLUSTERS:
                ms_by_route[name] = ms
                if name == "fused":
                    record = {"name": "vcc_joint_step", "route": "cuda",
                              "source": "src/repro_torch/kernels/vcc_pgd/"
                                        "csrc/joint_step.cu",
                              "replaces": "src/repro/kernels/vcc_pgd/"
                                          "kernel.py:207",
                              "max_abs_err": err, "s_max_abs_err": s_err,
                              "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": by,
                              "library_ms": None}
        if len(outs) == 2:
            (df, sf), (ds, ss) = outs["fused"], outs["split"]
            same_d = torch.equal(df.view(torch.int32), ds.view(torch.int32))
            gap = (sf - ss).abs().max().item()
            width = max(nu["wrapper"][:, 1].max().item(),
                        nu["split"][:, 1].max().item())
            print(f"[kernel] vcc_joint_step fused vs split route at {B} x "
                  f"{n}: d' bitwise equal: {same_d}; s' max gap {gap:.3e} "
                  f"(bracket width {width:.3e}; bitwise: {gap == 0.0})",
                  flush=True)
            if not (same_d and gap <= width):
                raise AssertionError("the fused and split routes disagree")
        del kern, pl, outs, wd, ws
    record["ms_by_route"] = ms_by_route
    return [record, phase_s_project(card)]


def phase_s_project(card):
    """The split route's shift update alone at the slice path's 28 x 512,
    against ``ref.project_row`` of z = s - lr_s g_s."""
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    dev = torch.device("cuda")
    B, n = SLICE_ROLLOUTS, MAIN_CLUSTERS
    g = torch.Generator().manual_seed(23)
    tau = 1.0 + 4.0 * torch.rand(B, n, generator=g)
    mob = 0.1 + 0.5 * torch.rand(B, 1, generator=g)
    mob[1] = 0.0
    s = tau * mob * (2 * torch.rand(B, n, generator=g) - 1)
    g_s = 100 * torch.rand(B, n, generator=g)
    lr_s = 0.002 + 0.004 * torch.rand(B, 1, generator=g)
    s, g_s, lo_s, ub_s, lr_s = (x.to(dev).contiguous() for x in (
        s, g_s, -mob * tau, mob * tau, lr_s))
    nu = torch.empty(B, 2, device=dev)

    def kern():
        return pgd_kernel.s_project_cuda(
            *(x.reshape(-1, 1) for x in (s, g_s)), lr_s,
            *(x.reshape(-1, 1) for x in (lo_s, ub_s)), n=n, nu_out=nu)

    def plain():
        return pgd_ref.project_row(s - lr_s * g_s, lo_s, ub_s)

    got, want = kern().reshape(B, n), plain()
    torch.cuda.synchronize()
    err, limit, resid, plain_resid, viol = shift_check(
        "s_project", B, n, got, want, s - lr_s * g_s,
        nu[:, 1].max().item(), lo_s, ub_s)
    ms = cuda_ms(kern, lead=True)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    bound_ms, by = card.bound(pgd_kernel.shift_flops(B, n),
                              pgd_kernel.shift_bytes(B, n))[:2]
    print(f"[kernel] s_project {B} x {n}: max|kernel-plain|={err:.3e} "
          f"(limit {limit:.3e}), conservation max|sum_c s'|={resid:.3e} "
          f"(plain {plain_resid:.3e}), box violation {viol:.3e}; kernel "
          f"{ms:.4f} ms (device), plain {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {by}; the design's "
          f"shuffle-issue floor "
          f"{1e3 * pgd_kernel.shift_shuffles(B) / card.shfl_per_s:.4f} ms",
          flush=True)
    return {"name": "vcc_s_project", "route": "cuda",
            "source": "src/repro_torch/kernels/vcc_pgd/csrc/joint_step.cu",
            "replaces": "src/repro/kernels/vcc_pgd/kernel.py:207",
            "part_of": "vcc_joint_step: its split route's shift update (the "
                       "reference runs it after joint_step_pallas, "
                       "src/repro/core/solver.py:165-167)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


# ------------------------------------------------- phase 3: kernels #4, #5

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # as the TPU test
GLA_RTOL = 1e-4                       # of max|o| and of max|state|
# the serving path's shapes: 4 prompts of 1,024 tokens, 32 decoded tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_ROUNDS = 4, 1024, 32, 2
SERVE_MAX_SEQ = SERVE_PROMPT + SERVE_GEN + 8
DECODE_POS = SERVE_PROMPT + SERVE_GEN // 2   # a mid-generation decode step
# Whisper-base's decoder prompts: 128 tokens, within its 448 decoder
# positions, on the encoder's 1,500 frames; Gemma2-9B's 4,608 tokens, the
# 4,096-key local window plus 512 and within its 8,192-token context, so
# that the window binds on its local layers in the prefill and at every
# decode step
SERVE_PROMPTS = {"whisper-base": 128, "gemma2-9b": 4096 + 512}
VISION_TOKENS, FRAMES = 256, 1500          # InternVL2-2B's, Whisper-base's


def flash_cases():
    """(label, B, Sq, Sk, N, K, H, dtype, mask options): the prefill and
    decode calls of Zamba2-7B's shared block (32 heads of 112),
    Qwen3-0.6B's layers (16 query heads on 8 KV heads of 128) and
    DeepSeekMoE-16B's layers (16 heads of 128, MHA), a ragged length,
    float32, and Gemma2-9B's widths (16 on 8 heads of 256) with its
    softcap of 50 and a 512-key window; InternVL2-2B's prefill over its
    256 vision positions and 1,024 prompt tokens and its last decode step
    (16 on 8 heads of 128); Whisper-base's calls (8 heads of 64): the
    encoder's non-causal self-attention over 1,500 frames, the decoder's
    non-causal cross-attention of 128 prompt positions and of one token
    over them (no cache length), the two cross calls in float32 too;
    DeepSeek-V2-236B's expanded MLA prefill (128 heads, q and k of head
    dim 192, v zero past its 128 columns: ``MLA_V_DIM``), in float32 too
    at a shorter sequence (the route of the float32 decode check); and the
    float32 prefill route's own cases (B * N = 65,536, H = 256 with window
    and softcap, a chunked prefill, GQA, H = 33) and the float32 prefills
    that ``[serve]``'s float32 checks run (DeepSeekMoE's and DeepSeek-V2's
    at 2 x 1,023 tokens); Yi-6B's (32 query heads on 4 KV heads of 128)
    and DeepSeek-67B's (64 on 8) prefill and decode, 8 query heads a KV
    head; Gemma2-9B's served calls (16 on 8 heads of 256, softcap 50) over
    its 4,608-token prompt on a local layer (window 4,096) and a global one
    (the ``GLOBAL_WINDOW`` sentinel, 1 << 30), and its decode step at a
    position past 4,096 on both, in bf16 and float32. The decode shapes
    run in float32 too: there the 2e-5 limit is far below the ~1e-3 that
    one key too many or too few (an off-by-one ``length``, ``q_offset``
    or window edge) moves an output row by, which bfloat16's 2e-2 limit
    would let through; the bf16 prefills under a binding window are held
    at its edge row by row (``window_edge_check``)."""
    from repro_torch.models.attention import GLOBAL_WINDOW
    B, P, M, pos = SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_SEQ, DECODE_POS
    bf, f = torch.bfloat16, torch.float32
    dec = dict(causal=True, q_offset=pos, length=pos + 1)
    # Gemma2-9B's served shapes: its prompt, its cache and a decode step
    # mid-generation, 528 keys past the local window's 4,096
    GP = SERVE_PROMPTS["gemma2-9b"]
    GM, gpos = GP + SERVE_GEN + 8, GP + SERVE_GEN // 2
    gdec = dict(causal=True, q_offset=gpos, length=gpos + 1, softcap=50.0)
    local, glob = dict(window=4096), dict(window=GLOBAL_WINDOW)
    V, E, W = VISION_TOKENS, FRAMES, SERVE_PROMPTS["whisper-base"]
    # InternVL2's last decode step: 1,312 keys of its 1,320-slot cache
    last = dict(causal=True, q_offset=V + P + SERVE_GEN - 1,
                length=V + P + SERVE_GEN)
    cross = dict(causal=False)
    return [
        ("zamba2 prefill", B, P, P, 32, 32, 112, bf, dict(causal=True)),
        ("zamba2 decode", B, 1, M, 32, 32, 112, bf, dec),
        ("qwen3 prefill (GQA)", B, P, P, 16, 8, 128, bf, dict(causal=True)),
        ("qwen3 decode (GQA)", B, 1, M, 16, 8, 128, bf, dec),
        ("zamba2 ragged", B, 1000, 1000, 32, 32, 112, bf, dict(causal=True)),
        ("zamba2 prefill float32", 1, 512, 512, 32, 32, 112, f,
         dict(causal=True)),
        ("zamba2 decode float32", B, 1, M, 32, 32, 112, f, dec),
        ("qwen3 decode float32 (GQA)", B, 1, M, 16, 8, 128, f, dec),
        ("gemma2 window + softcap", 2, P, P, 16, 8, 256, bf,
         dict(causal=True, window=512, softcap=50.0)),
        ("gemma2 decode window + softcap", 2, 1, M, 16, 8, 256, bf,
         dict(dec, window=512, softcap=50.0)),
        ("deepseek-moe prefill", B, P, P, 16, 16, 128, bf, dict(causal=True)),
        ("deepseek-moe decode", B, 1, M, 16, 16, 128, bf, dec),
        ("deepseek-moe decode float32", B, 1, M, 16, 16, 128, f, dec),
        ("internvl2 prefill (GQA)", B, V + P, V + P, 16, 8, 128, bf,
         dict(causal=True)),
        ("internvl2 decode (GQA)", B, 1, V + M, 16, 8, 128, bf, last),
        ("whisper encoder", B, E, E, 8, 8, 64, bf, cross),
        ("whisper cross prefill", B, W, E, 8, 8, 64, bf, cross),
        ("whisper cross decode", B, 1, E, 8, 8, 64, bf, cross),
        ("whisper cross prefill float32", B, W, E, 8, 8, 64, f, cross),
        ("whisper cross decode float32", B, 1, E, 8, 8, 64, f, cross),
        ("deepseek-v2 prefill (MLA)", B, P, P, 128, 128, 192, bf,
         dict(causal=True)),
        ("deepseek-v2 prefill float32 (MLA)", 2, 512, 512, 128, 128, 192, f,
         dict(causal=True)),
        # the float32 prefill route's own cases (flash_attention.cu): B * N
        # past a grid axis's 65,535 blocks, Gemma2's widths with window and
        # softcap at a ragged 1,000 tokens, Zamba2's chunked prefill (200
        # queries at 700..899 over a cache filled to 900), Qwen3's GQA, and
        # an unaligned head dim (element loads)
        ("many heads prefill float32 (B*N 65,536)", 1024, 24, 24, 64, 64, 16,
         f, dict(causal=True)),
        ("gemma2 prefill float32 window + softcap", 1, 1000, 1000, 16, 8,
         256, f, dict(causal=True, window=512, softcap=50.0)),
        ("zamba2 chunked prefill float32", 2, 200, M, 32, 32, 112, f,
         dict(causal=True, q_offset=700, length=900)),
        ("qwen3 prefill float32 (GQA)", 1, 512, 512, 16, 8, 128, f,
         dict(causal=True)),
        ("H=33 prefill float32", 2, 130, 130, 4, 4, 33, f,
         dict(causal=True)),
        # the float32 prefills that [serve]'s float32 checks run at full
        # width (moe_float32_checks): 2 x 1,023 tokens, a ragged last
        # query tile, on DeepSeekMoE's heads and DeepSeek-V2's MLA heads
        # (the HMAX = 192 instance)
        ("deepseek-moe prefill float32 (served)", 2, P - 1, P - 1, 16, 16,
         128, f, dict(causal=True)),
        ("deepseek-v2 prefill float32 (MLA, served)", 2, P - 1, P - 1, 128,
         128, 192, f, dict(causal=True)),
        # 8 query heads a KV head: the decode route's two row groups of 4
        # a KV head (decode_rows_per_block)
        ("yi-6b prefill (GQA 8:1)", B, P, P, 32, 4, 128, bf,
         dict(causal=True)),
        ("yi-6b decode (GQA 8:1)", B, 1, M, 32, 4, 128, bf, dec),
        ("yi-6b decode float32 (GQA 8:1)", B, 1, M, 32, 4, 128, f, dec),
        ("deepseek-67b prefill (GQA 8:1)", B, P, P, 64, 8, 128, bf,
         dict(causal=True)),
        ("deepseek-67b decode (GQA 8:1)", B, 1, M, 64, 8, 128, bf, dec),
        # Gemma2-9B served: the window binds on the local layers
        ("gemma2 local prefill (served, window 4096)", B, GP, GP, 16, 8,
         256, bf, dict(causal=True, softcap=50.0, **local)),
        ("gemma2 global prefill (served, window 1 << 30)", B, GP, GP, 16, 8,
         256, bf, dict(causal=True, softcap=50.0, **glob)),
        ("gemma2 local decode (served, window 4096)", B, 1, GM, 16, 8, 256,
         bf, dict(gdec, **local)),
        ("gemma2 global decode (served, window 1 << 30)", B, 1, GM, 16, 8,
         256, bf, dict(gdec, **glob)),
        ("gemma2 local decode float32 (window 4096)", B, 1, GM, 16, 8, 256,
         f, dict(gdec, **local)),
        ("gemma2 global decode float32 (window 1 << 30)", B, 1, GM, 16, 8,
         256, f, dict(gdec, **glob)),
    ]


# the MLA cases' v head dim: v is zero-padded from it to q's 192 columns
MLA_V_DIM = {"deepseek-v2 prefill (MLA)": 128,
             "deepseek-v2 prefill float32 (MLA)": 128,
             "deepseek-v2 prefill float32 (MLA, served)": 128}


def library_call(q, k, v, mask):
    """The library yardstick: (its name, one PyTorch call computing #4's
    function on the same inputs, heads-major views, GQA by ``enable_gqa``).
    ``scaled_dot_product_attention`` (an additive mask where there is a
    cache length or a window); under a softcap, which SDPA cannot take,
    ``flex_attention`` compiled (``flex_call``)."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if mask.get("softcap") is not None:
        return "flex_attention", flex_call(qt, kt, vt, mask, gqa)
    name = "scaled_dot_product_attention"
    if mask.get("length") is None and mask.get("window") is None:
        return name, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=mask.get("causal", True), enable_gqa=gqa)
    from repro_torch.kernels.flash_attention import ref as fa_ref
    qpos = mask.get("q_offset", 0) + torch.arange(q.shape[1], device=q.device)
    keep = fa_ref._mask(qpos, torch.arange(k.shape[1], device=q.device),
                        causal=mask.get("causal", True),
                        window=mask.get("window"), length=mask.get("length"))
    add = torch.zeros(keep.shape, dtype=q.dtype, device=q.device
                      ).masked_fill(~keep, float("-inf"))
    return name, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=add, enable_gqa=gqa)


@contextmanager
def stack_limit_kept():
    """The context's stack limit as it was on entry, set again on exit,
    which hands back the local memory that kernels launched inside grew
    it to: ``flex_attention``'s float32 kernels at head dim 256 take
    13,616 bytes a thread, which kept 3.2 GiB of the card reserved for the
    rest of the process (H100) and left the serving phase's largest check
    short of memory."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    stack = ctypes.c_size_t()                  # CU_LIMIT_STACK_SIZE = 0
    if cuda.cuCtxGetLimit(ctypes.byref(stack), 0) != 0:
        raise RuntimeError("cuCtxGetLimit(CU_LIMIT_STACK_SIZE) failed")
    try:
        yield
    finally:
        torch.cuda.synchronize()
        if cuda.cuCtxSetLimit(0, stack) != 0:
            raise RuntimeError("cuCtxSetLimit(CU_LIMIT_STACK_SIZE) failed")


def flex_call(qt, kt, vt, mask, gqa):
    """``flex_attention`` under ``torch.compile`` at heads-major q, k, v:
    the softcap as its score_mod (``cap * tanh(s / cap)`` of the scaled
    score, as ``ref._attend``), ``ref._mask``'s causal, window and length
    rules as a block mask built here (outside the timed call, as SDPA's
    additive mask). Dynamo is reset first, so each case compiles afresh
    and no case meets the recompile limit; Inductor's and Triton's caches
    go under ``build/``. Only this script calls it: the port never does."""
    import os
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" /
                                                          "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch._dynamo
    import torch._inductor.config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    # compile in this process: no pool of compile workers outlives it
    torch._inductor.config.compile_threads = 1
    torch._dynamo.reset()
    cap, off = mask["softcap"], mask.get("q_offset", 0)
    causal, window, length = (mask.get("causal", True), mask.get("window"),
                              mask.get("length"))

    def score_mod(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    def mask_mod(b, h, qi, ki):
        keep = ki >= 0
        if causal:
            keep = keep & (ki <= qi + off)
        if window is not None:
            keep = keep & (qi + off - ki < window)
        if length is not None:
            keep = keep & (ki < length)
        return keep
    block = create_block_mask(mask_mod, None, None, qt.shape[2], kt.shape[2],
                              device=qt.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=block,
                      scale=mask.get("scale"), enable_gqa=gqa)


FLASH_SOURCES = [f"src/repro_torch/kernels/flash_attention/csrc/{f}" for f in
                 ("flash_prefill.cu", "flash_decode.cu", "flash_attention.cu",
                  "flash_common.cuh")]


def flash_case(card, label, B, Sq, Sk, N, K, H, dt, mask):
    """One case of kernel #4 against its plain version (both called
    directly on CUDA tensors), timed beside one library call
    (``library_call``), with its route, rate and share of the bound; a
    bf16 prefill whose window binds also held at the window's edge
    (``window_edge_check``). Returns its record."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + H)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
               for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H)))
    vd = MLA_V_DIM.get(label)
    if vd is not None:
        v[..., vd:] = 0

    def kern():
        return fa_kernel.flash_attention_cuda(q, k, v, **mask)

    def plain():
        return fa_ref.attention_reference(q, k, v, **mask)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = FLASH_TOL[dt]
    ms, plain_ms = cuda_ms(kern, lead=True), cuda_ms(plain, reps=10)
    lib_name, lib = library_call(q, k, v, mask)
    with stack_limit_kept():
        lib_ms = cuda_ms(lib, lead=True)
    pairs = {k: x for k, x in mask.items() if k != "softcap"}
    flops = fa_kernel.attention_flops(B, Sq, Sk, N, H, **pairs)
    nbytes = fa_kernel.attention_bytes(B, Sq, Sk, N, K, H,
                                       q.element_size(), **pairs)
    bound_ms, by, ops_ms, bytes_ms = card.bound(flops, nbytes, dt)
    route = fa_kernel.route(Sq, dt)
    if route == "flash_decode":
        begin, end = fa_ref.key_span(Sq, Sk, **pairs)
        splits = fa_kernel.decode_splits(B, K, N // K * Sq, end - begin,
                                         card.sms)
        route += f" (splits {splits})"
    split, ceiling = "", {}
    if route == "flash_attention":
        # the route's own ceiling: three TF32 products per product
        split_ops_ms = 1e3 * 3 * flops / TF32_TENSOR_PER_S
        split_ms = max(bytes_ms, split_ops_ms)
        ceiling = {"ceiling_ms": split_ms, "ceiling_by": (
            "split-TF32 operations" if split_ops_ms >= bytes_ms
            else "bytes")}
        split = (f"; split-TF32 ceiling {split_ms:.4f} ms (max(bytes / "
                 f"3.35 TB/s, 3 x ops / 495 TFLOP/s TF32), "
                 f"{100 * split_ms / ms:.1f}% of it; the share above is of "
                 f"the FP32 bound)")
    print(f"[kernel] flash_attention {label}: B={B} Sq={Sq} Sk={Sk} "
          f"N={N} K={K} H={H} {str(dt)[6:]} {mask}: route {route}; "
          f"max|kernel-plain|={err:.3e} (limit {tol:g}); kernel "
          f"{ms:.4f} ms (device), {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{nbytes / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f}% of "
          f"the bound; plain {plain_ms:.4f} ms, library ({lib_name}) "
          f"{lib_ms:.4f} ms, kernel / library {ms / lib_ms:.2f}x"
          f"; bound {bound_ms:.4f} ms by {by} (matmul flops "
          f"{flops:.4g} -> {ops_ms:.4f} ms, bytes {nbytes:.4g} -> "
          f"{bytes_ms:.4f} ms){split}", flush=True)
    if not err <= tol:
        raise AssertionError(f"flash attention disagrees with plain: "
                             f"{label}, {err:.3e}")
    edge = {}
    W = mask.get("window")
    if dt == torch.bfloat16 and Sq > 1 and W is not None \
            and W < mask.get("q_offset", 0) + Sq:
        edge = {"window_edge": window_edge_check(label, got, want, q, k, v,
                                                 mask)}
    if vd is not None:
        pad = got[..., vd:].abs().max().item()
        print(f"[kernel] flash_attention {label}: the output's columns "
              f"{vd}..{H - 1} (v's zero padding) max|.| = {pad} (must "
              f"be 0: the model slices them off)", flush=True)
        if pad != 0:
            raise AssertionError(f"{label}: padded columns not zero")
    if label in P_ROUNDING_CASES:
        p_rounding(label, route, got, want, q, k, v, mask)
    rec = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc",
        "sources": FLASH_SOURCES,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
        "library": lib_name, **ceiling, **edge}
    del q, k, v, got, want
    return rec


ROW_RTOL = 2e-2   # a windowed bf16 prefill's rows: of each row's max|plain|


def window_edge_check(label, got, want, q, k, v, mask):
    """A bf16 prefill whose window binds, held at its window's edge: over
    the rows the window cuts (query positions >= window - 1), each output
    row (a query and a head) within ``ROW_RTOL`` of that row's max|plain|;
    and, as the control, the plain version at a window one key shorter and
    one key longer off the plain version by more than that limit on some
    row. Under a 4,096-key window the rows are ~0.02 in size, so a key
    too many or too few moves them by less than bf16's absolute 2e-2 but
    by ~0.1 of a row's max. Returns the row error and the two controls."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    W, off = mask["window"], mask.get("q_offset", 0)
    rows = slice(max(0, W - 1 - off), None)

    def row_rel(a, b):
        a, b = a[:, rows].float(), b[:, rows].float()
        return ((a - b).abs().amax(-1)
                / b.abs().amax(-1).clamp(min=1e-30)).max().item()
    err = row_rel(got, want)
    ctl = [row_rel(fa_ref.attention_reference(q, k, v, **dict(
        mask, window=W + d)), want) for d in (-1, 1)]
    print(f"[kernel] flash_attention {label}: window edge, rows at "
          f"positions >= {W - 1}: max|kernel-plain| / the row's max|plain| "
          f"{err:.3e} (limit {ROW_RTOL:g}); control, plain at window "
          f"{W - 1} / {W + 1} against window {W}: {ctl[0]:.3e} / "
          f"{ctl[1]:.3e} (each must pass the limit)", flush=True)
    if not err <= ROW_RTOL < min(ctl):
        raise AssertionError(f"{label}: window edge {err:.3e}, controls "
                             f"{ctl} against {ROW_RTOL:g}")
    return {"row_rel_err": err, "control_shorter": ctl[0],
            "control_longer": ctl[1], "limit": ROW_RTOL}


def case_row(rec):
    """A ``flash_case`` record as #4's ``by_case`` keeps it: its times and
    bound, the library call it was timed against, on the float32 prefill
    route its split-TF32 ceiling, and on a windowed bf16 prefill its
    window edge check."""
    return {k: rec[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library", "max_abs_err", "ceiling_ms", "ceiling_by", "window_edge")
        if k in rec}


def phase_flash_kernel(card):
    """Kernel #4 against its plain version at every case of
    ``flash_cases`` (``flash_case``); then the decode route's split
    partials against ``ref.attention_partials``."""
    records = {case[0]: flash_case(card, *case) for case in flash_cases()}
    flash_partials_check()
    rec = records["zamba2 prefill"]
    rec["decode_ms"] = records["zamba2 decode"]["ms"]
    rec["by_case"] = {label: case_row(r) for label, r in records.items()}
    return rec


# the bf16 serving calls whose rounding of P is held against the TPU
# kernel's arithmetic
P_ROUNDING_CASES = ("zamba2 prefill", "zamba2 decode", "qwen3 prefill (GQA)",
                    "qwen3 decode (GQA)", "deepseek-v2 prefill (MLA)",
                    "deepseek-moe prefill",
                    "deepseek-moe decode")


def p_rounding(label, route, got, want, q, k, v, mask):
    """How a bf16 route rounds P, at a serving shape: the kernel's output
    against ``ref.attention_reference`` (which rounds the normalised P to
    bf16 before P V) and against float32 attention of the same bf16 inputs,
    rounded to bf16 only at the output (the TPU kernel's arithmetic: it
    keeps P in float32); and the reference against that float32
    attention."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    f32 = fa_ref.attention_reference(q.float(), k.float(), v.float(),
                                     **mask).to(q.dtype).float()
    got, want = got.float(), want.float()
    print(f"[kernel] flash_attention P rounding, {label}: route {route}; "
          f"max|kernel - attention_reference| "
          f"{(got - want).abs().max().item():.3e}, max|kernel - float32 "
          f"attention| {(got - f32).abs().max().item():.3e}, "
          f"max|attention_reference - float32 attention| "
          f"{(want - f32).abs().max().item():.3e}; mean|kernel - float32 "
          f"attention| {(got - f32).abs().mean().item():.3e}, "
          f"mean|attention_reference - float32 attention| "
          f"{(want - f32).abs().mean().item():.3e} (max|float32 attention| "
          f"{f32.abs().max().item():.3e})", flush=True)


def flash_partials_check(splits=5):
    """The decode route's float32 split partials (m, l, acc) at Zamba2's
    decode shape against ``ref.attention_partials``, and their merge
    against ``ref.attention_reference``."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    B, M, pos = SERVE_BATCH, SERVE_MAX_SEQ, DECODE_POS
    mask = dict(causal=True, q_offset=pos, length=pos + 1)
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(s, generator=g, device="cuda")
               for s in ((B, 1, 32, 112), (B, M, 32, 112), (B, M, 32, 112)))
    got = fa_kernel.flash_decode_partials_cuda(q, k, v, splits=splits,
                                               **mask)
    want = fa_ref.attention_partials(q, k, v, splits, **mask)
    torch.cuda.synchronize()
    errs = [((x - y).abs().max() / y.abs().max().clamp_min(1.0)).item()
            for x, y in zip(got, want)]
    merged = fa_ref.combine_partials(*got)
    gap = (merged - fa_ref.attention_reference(q, k, v, **mask)
           ).abs().max().item()
    print(f"[kernel] flash_decode partials, {splits} splits at Zamba2's "
          f"decode shape, float32: max|kernel-plain| / max(1, max|plain|) "
          f"m {errs[0]:.3e}, l {errs[1]:.3e}, acc {errs[2]:.3e}; their "
          f"merge vs attention_reference {gap:.3e} (limit "
          f"{FLASH_TOL[torch.float32]:g} each)", flush=True)
    if not max(errs + [gap]) <= FLASH_TOL[torch.float32]:
        raise AssertionError("flash decode partials disagree with plain")


RWKV_SERVE_CASE = "rwkv6-7b serving prefill"


def gla_cases():
    """(label, B, S, H, K, V, dtype, mode, chunk, initial state):
    Zamba2-7B's Mamba2 prefill (112 heads, state 64, head 64, chunk 256;
    B and C shared by the heads), a ragged length, a prefill from a state,
    a one-token scan from a state, float32; RWKV6-7B's widths (64 heads of
    64, chunk 64) with per-channel decay, with its bonus in the strict
    mode from a state, the same at log decays of -30 a step and below
    (``strong``), at a ragged 1,000 tokens, and at its serving prefill's
    shape (the batch of 4 x 1,024 tokens a layer of the serving path
    scans, from no state). Then the split-TF32 route's own cases
    (``gla_scan.cu``): RWKV6-7B in float32 at 2 x 1,024 with its bonus in
    the strict mode from a state, the same at decays of -30 a step, odd
    widths (K = 24, V = 40) over a ragged 1,000 tokens, a bf16 scalar
    decay with the bonus in the strict mode (``scalar+bs``: Zamba2's
    shape, which no model sends, the bf16 tensor-core routes refuse it)
    and a float32 one-token scan from a state."""
    B, P = SERVE_BATCH, SERVE_PROMPT
    bf, f = torch.bfloat16, torch.float32
    return [
        ("zamba2 mamba2 prefill", B, P, 112, 64, 64, bf, "scalar", 256,
         False),
        ("zamba2 ragged", B, 1000, 112, 64, 64, bf, "scalar", 256, False),
        ("zamba2 from a state", B, P, 112, 64, 64, bf, "scalar", 256, True),
        ("zamba2 one token from a state", B, 1, 112, 64, 64, bf, "scalar",
         256, True),
        ("zamba2 float32", 1, P, 112, 64, 64, f, "scalar", 256, True),
        ("rwkv6 vector decay", 2, P, 64, 64, 64, bf, "vector", 64, False),
        ("rwkv6 bonus + strict", 2, P, 64, 64, 64, bf, "rwkv", 64, True),
        ("rwkv6 strong decay", 2, P, 64, 64, 64, bf, "strong", 64, True),
        ("rwkv6 ragged", B, 1000, 64, 64, 64, bf, "rwkv", 64, True),
        (RWKV_SERVE_CASE, B, P, 64, 64, 64, bf, "rwkv", 64, False),
        ("rwkv6 float32", 2, P, 64, 64, 64, f, "rwkv", 64, True),
        ("rwkv6 float32 strong decay", 2, P, 64, 64, 64, f, "strong", 64,
         True),
        ("float32 odd widths", 2, 1000, 64, 24, 40, f, "rwkv", 64, True),
        ("zamba2 bf16 bonus + strict", B, P, 112, 64, 64, bf, "scalar+bs",
         256, True),
        ("zamba2 float32 one token", 1, 1, 112, 64, 64, f, "scalar", 256,
         True),
    ]


def gla_mode(mode):
    """(per-channel decay, bonus, strict) of a ``gla_cases`` mode."""
    bs = mode in ("rwkv", "strong", "scalar+bs")
    return mode not in ("scalar", "scalar+bs"), bs, bs


def gla_inputs(B, S, H, K, V, dt, mode, init, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    if not gla_mode(mode)[0]:  # Mamba2: B, C shared by the heads (stride 0)
        q, k = (n(B, S, 1, K).to(dt).expand(B, S, H, K) for _ in range(2))
        ld = -0.7 * n(B, S, H).abs()
        u = n(H, K) if gla_mode(mode)[1] else None
    else:
        q, k = n(B, S, H, K).to(dt), n(B, S, H, K).to(dt)
        ld = -(30.0 + n(B, S, H, K).abs()) if mode == "strong" else \
            -3.0 * n(B, S, H, K).abs()
        u = n(H, K) if gla_mode(mode)[1] else None
    v = n(B, S, H, V).to(dt)
    h0 = n(B, H, K, V) if init else None
    return q, k, v, ld, u, h0


GLA_SOURCES = [f"src/repro_torch/kernels/linear_scan/csrc/{f}" for f in
               ("gla_ssd.cu", "gla_vec.cu", "gla_scan.cu")]
GLA_ROUTE_NOTE = {"gla_ssd": "(64-row tiles, tensor cores)",
                  "gla_vec": "(64-row tiles in 16-row sub-blocks, tensor "
                             "cores; 8-row triangles on the CUDA cores)",
                  "gla_scan": "(64-row tiles, tensor cores in split TF32)"}
# the entry point of gla_scan.cu before its split-TF32 redesign (the
# CUDA-core kernel, which took the tile's rows as its last argument)
PARENT_GLA_SIG = "p" * 8 + "i" * 21


def load_parent_scan(directory):
    """The entry point of an earlier ``gla_scan.cu`` (one with the parent
    commit's arguments) in ``directory``, built into ``build/``."""
    from repro_torch.kernels import nvcc
    lib = nvcc.build(Path(directory) / "gla_scan.cu")[0]
    return nvcc.load(lib, "gla_scan_fwd", PARENT_GLA_SIG)


def run_parent_scan(fn, q, k, v, ld, *, bonus=None, strict=False, chunk=64,
                    initial_state=None):
    """The earlier ``gla_scan.cu`` on the operands of ``run_source``, in
    tiles of ``tile_rows(chunk)``. Returns (o, final_state)."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    B, S, H, K = q.shape
    V = v.shape[-1]
    st = [nvcc.lead_strides(n, x, d) for n, x, d in (
        ("q", q, 4), ("k", k, 4), ("v", v, 4),
        ("log_decay", ld, ld.dim()))]
    o = torch.empty((B, S, H, V), dtype=q.dtype, device=q.device)
    hT = torch.empty((B, H, K, V), dtype=torch.float32, device=q.device)
    nvcc.launch(fn, q.device, (
        q, k, v, ld, bonus, initial_state, o, hT,
        gla_kernel._DTYPES[q.dtype], B, S, H, K, V, *st[0], *st[1], *st[2],
        *st[3], int(ld.dim() == 4), int(bool(strict)),
        gla_kernel.tile_rows(chunk)), "parent gla_scan")
    return o, hT


def phase_gla_kernel(card, parent=None):
    """Kernel #5 against its plain version (both called directly on CUDA
    tensors). The state is float32 and held to 1e-4 of max|state|; so is
    a float32 output. A bf16 output rounds the same float32 sum on both
    sides, so it is held to 1e-4 of max|o| plus one bf16 unit in the last
    place of the plain value. At RWKV6-7B's serving prefill the split-TF32
    source ``gla_scan.cu`` runs on the same inputs too (``run_source``),
    held to the same limits and timed in turns with the route. Each case
    on ``gla_scan.cu`` also gets its split-TF32 ceiling and, given
    ``parent`` (a directory holding an earlier ``gla_scan.cu``, e.g. the
    parent commit's), that source's time in turns on the same inputs.
    Returns #5's record (every case's numbers in ``by_case``) and its RWKV6
    route's."""
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    from repro_torch.kernels.linear_scan import ref as gla_ref
    dev = torch.device("cuda")
    records = {}
    parent_fn = None if parent is None else load_parent_scan(parent)
    for i, (label, B, S, H, K, V, dt, mode, chunk, init) in enumerate(
            gla_cases()):
        q, k, v, ld, u, h0 = gla_inputs(B, S, H, K, V, dt, mode, init, dev,
                                        100 + i)
        vec, bonus, strict = gla_mode(mode)
        kw = dict(bonus=u, strict=strict, chunk=chunk, initial_state=h0)

        def kern():
            return gla_kernel.gla_cuda(q, k, v, ld, **kw)

        def plain():
            return gla_ref.gla_chunked(q, k, v, ld, **kw)

        def old():
            return gla_kernel.run_source("gla_scan", q, k, v, ld, **kw)

        def prev():
            return run_parent_scan(parent_fn, q, k, v, ld, **kw)

        before = dict(gla_kernel.gla_cuda.routes)
        o, hT = kern()
        ran = [r for r, n in gla_kernel.gla_cuda.routes.items()
               if n != before[r]]
        want = gla_kernel.route(dt, K, V, vec=vec, bonus=bonus,
                                strict=strict)
        if ran != [want]:
            raise AssertionError(f"gla scan {label}: launched on {ran}, "
                                 f"route() says {want}")
        route = ran[0]
        wo, whT = plain()
        torch.cuda.synchronize()
        o_scale = wo.float().abs().max().item()
        s_scale = whT.abs().max().item()
        ulp = 0.0 if dt == torch.float32 else 2.0 ** -7

        def check(o, hT):
            err = (o.float() - wo.float()).abs()
            excess = (err - GLA_RTOL * o_scale
                      - ulp * wo.float().abs()).max().item()
            s_err = (hT - whT).abs().max().item()
            finite = bool(torch.isfinite(o.float()).all()
                          and torch.isfinite(hT).all())
            return err.max().item(), s_err, (
                finite and excess <= 0.0 and s_err <= GLA_RTOL * s_scale)

        err, s_err, ok = check(o, hT)
        ab = label == RWKV_SERVE_CASE and route != "gla_scan"
        pab = parent_fn is not None and route == "gla_scan"
        if ab or pab:   # another source on the same call, timed in turns
            other = old if ab else prev
            old_err, old_s_err, old_ok = check(*other())
            ms_list, old_list = [], []
            for r in range(2):
                for fn, acc in ((kern, ms_list), (other, old_list))[::(
                        1 if r == 0 else -1)]:
                    acc.append(cuda_ms(fn, lead=True))
            ms, old_ms = statistics.fmean(ms_list), statistics.fmean(old_list)
        else:
            ms = cuda_ms(kern, lead=True)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        flops = gla_kernel.gla_flops(B, S, H, K, V, vec=vec, bonus=bonus,
                                     strict=strict, chunk=chunk)
        nbytes = gla_kernel.gla_bytes(q, k, v, ld, bonus=u,
                                      initial_state=h0)
        bound_ms, by, ops_ms, bytes_ms = card.bound(flops, nbytes, dt)
        split, ceiling = "", {}
        if route == "gla_scan":
            # the route's own ceiling: three TF32 products per product
            split_ops_ms = 1e3 * 3 * flops / TF32_TENSOR_PER_S
            split_ms = max(bytes_ms, split_ops_ms)
            ceiling = {"ceiling_ms": split_ms, "ceiling_by": (
                "split-TF32 operations" if split_ops_ms >= bytes_ms
                else "bytes")}
            split = (f"; split-TF32 ceiling {split_ms:.4f} ms (max(bytes / "
                     f"3.35 TB/s, 3 x ops / 495 TFLOP/s TF32), "
                     f"{100 * split_ms / ms:.1f}% of it")
        print(f"[kernel] gla_scan {label}: B={B} S={S} H={H} K={K} V={V} "
              f"{str(dt)[6:]} {mode} chunk={chunk} initial state {init}: "
              f"route {route} " + GLA_ROUTE_NOTE[route] + ": "
              f"max|o kernel-plain|={err:.3e} of max|o| "
              f"{o_scale:.3e} (limit {GLA_RTOL:g} x max|o|"
              + (" + 1 bf16 ulp" if ulp else "") + "), max|state "
              f"kernel-plain|={s_err:.3e} of {s_scale:.3e} (limit "
              f"{GLA_RTOL:g} x); kernel {ms:.4f} ms (device), plain "
              f"{plain_ms:.4f} ms, library none (no single call); bound "
              f"{bound_ms:.4f} ms by {by} (matmul flops {flops:.4g} -> "
              f"{ops_ms:.4f} ms, bytes {nbytes:.4g} -> {bytes_ms:.4f} ms)"
              f"{split}", flush=True)
        if ab or pab:
            what = ("gla_scan.cu (split TF32)" if ab else
                    f"the earlier gla_scan.cu in {parent} (tile "
                    f"{gla_kernel.tile_rows(chunk)})")
            print(f"[kernel] gla_scan {label}: {route} {ms:.4f} ms "
                  f"({[round(x, 4) for x in ms_list]}) against {what} "
                  f"{old_ms:.4f} ms ({[round(x, 4) for x in old_list]}), "
                  f"in turns on the same inputs: {old_ms / ms:.2f}x; "
                  f"bound {bound_ms:.4f} ms ({ms / bound_ms:.1f}x and "
                  f"{old_ms / bound_ms:.1f}x it), plain {plain_ms:.4f} ms; "
                  f"its max|o - plain| {old_err:.3e}, state "
                  f"{old_s_err:.3e}", flush=True)
            if ab and not old_ok:
                raise AssertionError("gla_scan.cu disagrees with plain at "
                                     f"{label}")
        if not ok:
            raise AssertionError(f"gla scan disagrees with plain: {label}")
        records[label] = {
            "name": "gla_scan", "route": "cuda",
            "source": f"src/repro_torch/kernels/linear_scan/csrc/{route}.cu",
            "sources": GLA_SOURCES, "gla_route": route,
            "replaces": "src/repro/kernels/linear_scan/kernel.py:71",
            "max_abs_err": err, "state_err": s_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, **ceiling}
        if ab:
            records[label]["gla_scan_cu_ms"] = old_ms
        elif route == "gla_scan":
            records[label]["gla_scan_cu_ms"] = ms
        if pab:
            records[label]["parent_ms"] = old_ms
        del q, k, v, ld, o, wo
    rec = records["zamba2 mamba2 prefill"]
    vec_rec = dict(records[RWKV_SERVE_CASE], name="gla_vec",
                   at=RWKV_SERVE_CASE)
    rec["rwkv6_serving"] = {k: vec_rec[k] for k in (
        "source", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "gla_scan_cu_ms")}
    rec["by_case"] = {label: {k: r[k] for k in (
        "gla_route", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "state_err", "ceiling_ms", "ceiling_by", "gla_scan_cu_ms",
        "parent_ms") if k in r} for label, r in records.items()}
    return rec, vec_rec


# ------------------------------------------------------------------ phase 4

SOLVE_ROUNDS = 20                    # solve_vcc's dual-ascent rounds a day


def check_day(d, out):
    """Every day's solution conserves and stays within its bounds (those
    of the problem it solved: at the shifted budgets, when they moved)."""
    from repro_torch.core import vcc
    lo, ub, feasible = vcc.delta_bounds(out.prob)
    lo = torch.where(feasible[..., None], lo, 0.0)
    ub = torch.where(feasible[..., None], ub, 0.0)
    delta = out.sol.delta
    resid = delta.sum(-1).abs().max().item()
    viol = torch.clamp(torch.maximum(lo - delta, delta - ub), min=0.0
                       ).max().item()
    scale = max(ub.abs().max().item(), 1.0)
    if not (resid <= 1e-4 * scale and viol <= 1e-5 * scale):
        raise AssertionError(f"day {d}: delta conservation residual "
                             f"{resid:.3e} or bound violation {viol:.3e} "
                             f"beyond 1e-4 / 1e-5 x {scale:.3g}")
    return resid, viol


def phase_main_path():
    from repro_torch import sim
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    cfg = sim.SimConfig(n_clusters=MAIN_CLUSTERS, n_campuses=64, n_zones=16,
                        pds_per_cluster=2, hist_days=35)
    scenarios = sim.default_library(MAIN_DAYS)
    t0 = time.perf_counter()
    params = sim.build_batch(cfg, scenarios, MAIN_SEEDS, MAIN_DAYS)
    torch.cuda.synchronize()
    rows = len(scenarios) * len(MAIN_SEEDS) * cfg.n_clusters
    if rows != MAIN_ROWS:
        raise AssertionError(f"main path has {rows} kernel rows, the kernel "
                             f"phase measured {MAIN_ROWS}")
    print(f"[main] {len(scenarios)} scenarios x {len(MAIN_SEEDS)} seeds, "
          f"{MAIN_DAYS} days, {cfg.n_clusters} clusters / "
          f"{cfg.n_campuses} campuses / {cfg.n_zones} zones, hist "
          f"{cfg.hist_days} days; kernel rows per launch {rows}; params "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    marks, checks, backlog = {}, [], {}

    def on_day(d, state, out):
        torch.cuda.synchronize()
        marks[d] = time.perf_counter()
        if out is None:
            backlog["queue"] = state.queue.sum(-1)
            backlog["state0"] = state
        else:
            checks.append(check_day(d, out))

    run = sim.rollout_batch(cfg, MAIN_DAYS, device="cuda", on_day=on_day)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, ledger, traj = run(params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = pgd_kernel.pgd_epoch_cuda.launches
    others = read_counts()[1:]
    if any(others):
        raise AssertionError(f"the main path launched the slice kernels "
                             f"{others} times")
    burn_s, roll_s = marks[-1] - t0, t1 - marks[-1]
    batch = len(scenarios) * len(MAIN_SEEDS)
    print(f"[main] burn-in {burn_s:.3f} s; rollout {roll_s:.3f} s for "
          f"{MAIN_DAYS} days; {batch * MAIN_DAYS / roll_s:.3f} fleet-days/s "
          f"({batch} fleets of {cfg.n_clusters} clusters); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    worst = tuple(max(c[i] for c in checks) for i in range(2))
    print(f"[main] vcc_pgd_epoch launches {launches} (expected "
          f"{MAIN_DAYS * SOLVE_ROUNDS}); worst daily conservation residual "
          f"{worst[0]:.3e}, bound violation {worst[1]:.3e}", flush=True)
    if launches != MAIN_DAYS * SOLVE_ROUNDS:
        raise AssertionError(f"the main path launched the kernel {launches} "
                             f"times, expected {MAIN_DAYS * SOLVE_ROUNDS}")
    for name, val in list(ledger._asdict().items()) + list(traj.items()):
        if not torch.isfinite(val).all():
            raise AssertionError(f"non-finite values in {name}")
    rows = sim.scenario_rows(ledger, [s.name for s in scenarios],
                             len(MAIN_SEEDS), horizon_days=MAIN_DAYS,
                             initial_backlog=backlog["queue"])
    print(sim.format_table(rows), flush=True)
    profile_day(cfg, params, state, "profile_day.txt")
    RUNS["main"] = dict(cfg=cfg, params=params, state0=backlog["state0"],
                        out=(state, ledger, traj),
                        names=[s.name for s in scenarios], days=MAIN_DAYS)
    return launches


def tensor_leaves(tree):
    out = []
    from repro_torch.core.stages import map_tensors
    map_tensors(out.append, tree)
    return out


def phase_sharded():
    """The main path's batch through ``sim.rollout_batch_sharded``: with
    the default devices (every card: one here) and as two shards on
    cuda:0. Each run starts from the same params; its state, ledger and
    traj must equal [main]'s bit for bit, with 140 launches of #1 a
    shard."""
    from repro_torch import sim
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    main = RUNS["main"]
    cfg, params = main["cfg"], main["params"]
    want = tensor_leaves(main["out"])
    for label, devices in (("default devices", None),
                           ("two shards on cuda:0", ("cuda:0", "cuda:0"))):
        shards = torch.cuda.device_count() if devices is None \
            else len(devices)
        run = sim.rollout_batch_sharded(cfg, MAIN_DAYS, devices=devices)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tensor_leaves(run(params))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts()
        equal = sum(torch.equal(a, b) for a, b in zip(got, want))
        expect = [shards * MAIN_DAYS * SOLVE_ROUNDS, 0, 0, 0, 0]
        print(f"[sharded] {label}: {shards} shard(s) of "
              f"{params.key.shape[0] // shards} rollouts, burn-in and "
              f"{MAIN_DAYS} days in {secs:.2f} s; launches of #1 to #5 "
              f"{launches} (expected {expect}: "
              f"{MAIN_DAYS * SOLVE_ROUNDS} of #1 a shard); state, ledger and "
              f"traj: {equal} of {len(want)} tensors bit for bit [main]'s",
              flush=True)
        if launches != expect:
            raise AssertionError(f"[sharded] {label}: launches {launches}")
        if len(got) != len(want) or equal != len(want):
            raise AssertionError(f"[sharded] {label}: {len(want) - equal} "
                                 "tensors differ from [main]'s")


CALIBRATE_CLUSTERS = (0, 171, 342)       # of the main path's first rollout


def phase_calibrate():
    """``forecast.calibrate_half_lives`` on the card against the CPU, on
    three clusters' hourly inflexible history of the main path's burned-in
    state (35 days: the 14-day walk-forward needs three weeks or more,
    which the golden configuration's 14 days do not hold): the same pair,
    and the 6 x 6 MAPE surface within 1e-5 relative."""
    from repro_torch.core import forecast
    hist = RUNS["main"]["state0"].hist_uif[0, list(CALIBRATE_CLUSTERS)]
    g = len(forecast.GRID)
    for i, c in enumerate(CALIBRATE_CLUSTERS):
        surf, pair = {}, {}
        for where, dev in (("card", "cuda"), ("host", "cpu")):
            h = hist[i].to(dev)
            garr = torch.tensor(forecast.GRID, device=dev)
            surf[where] = forecast._walk_forward_mape(
                h, garr.repeat_interleave(g), garr.repeat(g)).cpu()
            pair[where] = forecast.calibrate_half_lives(h)
        ref = surf["host"]
        gap = ((surf["card"] - ref).abs() / ref).max().item()
        best2 = torch.sort(ref).values[:2]
        print(f"[calibrate] cluster {c}: pair on the card {pair['card']}, "
              f"on the CPU {pair['host']}; MAPE surface "
              f"{ref.min().item():.5f}..{ref.max().item():.5f}, card vs "
              f"CPU largest relative gap {gap:.3e} (limit 1e-5); the best "
              f"two differ by {(best2[1] / best2[0] - 1).item():.3e} "
              f"relative", flush=True)
        if pair["card"] != pair["host"] or not gap <= 1e-5:
            raise AssertionError(f"[calibrate] cluster {c}: the card and "
                                 "the CPU disagree")


def kernel_counters():
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    return (pgd_kernel.pgd_epoch_cuda, pgd_kernel.pgd_epoch_ens_cuda,
            pgd_kernel.joint_step_cuda, fa_kernel.flash_attention_cuda,
            gla_kernel.gla_cuda)


def reset_counts():
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    for k in kernel_counters():
        k.launches = 0
    pgd_kernel.s_project_cuda.launches = 0
    pgd_kernel.joint_step_cuda.routes = {"fused": 0, "split": 0}
    fa_kernel.flash_attention_cuda.routes = dict.fromkeys(
        fa_kernel.SOURCES, 0)
    gla_kernel.gla_cuda.routes = dict.fromkeys(gla_kernel.SOURCES, 0)


def read_counts():
    """Launches of kernels #1 to #5 since the last reset."""
    return [k.launches for k in kernel_counters()]


OURS = ("pgd_epoch_kernel", "pgd_epoch_ens_kernel", "joint_step_kernel",
        "joint_step_s_kernel", "s_project_kernel", "flash_attention_kernel", "flash_prefill_bf16_kernel",
        "flash_decode_split_kernel", "flash_decode_combine_kernel",
        "gla_scan_kernel", "gla_ssd_kernel", "gla_vec_kernel")


def profile_call(fn, fname, what):
    """``fn()`` once under torch.profiler: the device's busy share of its
    wall time and the ops that take it; the full table goes to
    chiprun_out/<fname>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()

    def self_dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device busy time: the kernels themselves (the ATen ops that launch
    # them carry the same time again, so they are left out of the sum)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(self_dev_us(e) for e in kernels) / 1e3
    # by launcher: ATen ops, and kernels launched outside ATen (ours)
    launchers = [e for e in events if e.device_type != DeviceType.CUDA
                 and self_dev_us(e) > 0]
    launchers += [e for e in kernels if "at::native" not in e.key]
    top = sorted(launchers, key=self_dev_us, reverse=True)[:8]
    ours = {}
    print(f"[profile] {what}: wall {wall_ms:.1f} ms under the "
          f"profiler, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%) in {sum(e.count for e in kernels)}"
          " kernel launches; device time by launcher: "
          + "; ".join(f"{e.key.split('(float')[0][:48]} "
                      f"{self_dev_us(e) / 1e3:.1f} ms x{e.count}"
                      for e in top), flush=True)
    for e in kernels:
        for k in OURS:
            if f"::{k}" not in e.key:
                continue
            name = e.key[e.key.index(f"::{k}") + 2:].split("(")[0]
            ours[k] = ours.get(k, 0.0) + self_dev_us(e) / 1e3
            print(f"[profile]   {name}: "
                  f"{self_dev_us(e) / 1e3:.3f} ms device over {e.count} "
                  f"launches, {self_dev_us(e) / e.count:.2f} us each",
                  flush=True)
    sort_key = "self_device_time_total" if hasattr(
        top[0], "self_device_time_total") else "self_cuda_time_total"
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / fname).write_text(events.table(sort_by=sort_key, row_limit=40))
    return wall_ms, busy_ms, ours, sum(e.count for e in kernels)


def profile_day(cfg, params, state, fname, days=MAIN_DAYS):
    """One more day under torch.profiler, after the counted run."""
    from repro_torch import sim
    from repro_torch.sim import engine
    step = sim.make_day_step(cfg)
    xs = engine.day_xs(params, days - 1)
    return profile_call(lambda: step(params, state, xs), fname,
                        "one day step")


# ------------------------------------------------------------------ phase 5

JOINT_ROUNDS, JOINT_STEPS = 8, 25     # solve_joint: 8 rounds x 25 steps


def slice_config(**kw):
    from repro_torch import sim
    base = dict(n_clusters=MAIN_CLUSTERS, n_campuses=64, n_zones=16,
                pds_per_cluster=2, hist_days=35, joint_spatial=True,
                n_members=SLICE_MEMBERS)
    return sim.SimConfig(**{**base, **kw})


def slice_scenarios(days):
    from repro_torch import sim
    return sim.mobility_sweep_library(days) + sim.risk_sweep_library(days)


def kept_days(bests, names, S):
    """Rollout-days on which the joint solve kept its joint point (the
    others kept the sequential warm start), in all and per scenario, and
    how close the calls were; ``bests`` holds one ``spatial.BestOf`` a
    day, the batch scenario-major."""
    t = torch.stack([b.take for b in bests], 1).cpu()
    m = torch.stack([b.margin for b in bests], 1).cpu()
    per = t.reshape(len(names), S, -1).sum((1, 2))
    kept = {"all": int(t.sum()), **{n: int(k) for n, k in zip(names, per)}}
    print(f"[slice] joint point kept on {kept['all']} of {t.numel()} "
          "rollout-days; per scenario: "
          + ", ".join(f"{n} {kept[n]}/{S * t.shape[1]}" for n in names)
          + "; the call's margin (the joint point's smaller relative gain "
          "in objective and carbon) per scenario, max and median: "
          + ", ".join(f"{n} {mx:.3e} / {md:.3e}" for n, mx, md in zip(
              names, m.reshape(len(names), -1).amax(1),
              m.reshape(len(names), -1).median(1).values)), flush=True)
    return kept


def phase_slice_path():
    """The risk-aware joint day at full width, on the card. Fails if a
    joint step took any route but the fused one, or an eager projection
    ran on the card."""
    from repro_torch import sim
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    cfg = slice_config()
    scenarios = slice_scenarios(MAIN_DAYS)
    names = [s.name for s in scenarios]
    n_mob = len(sim.mobility_sweep_library(MAIN_DAYS))
    S = len(MAIN_SEEDS)
    t0 = time.perf_counter()
    params = sim.build_batch(cfg, scenarios, MAIN_SEEDS, MAIN_DAYS)
    torch.cuda.synchronize()
    rows = len(scenarios) * S * cfg.n_clusters
    if rows != SLICE_ROWS:
        raise AssertionError(f"slice path has {rows} kernel rows, the "
                             f"kernel phases measured {SLICE_ROWS}")
    print(f"[slice] joint_spatial=True, n_members={cfg.n_members}: "
          f"{len(scenarios)} scenarios ({', '.join(names)}) x {S} seeds, "
          f"{MAIN_DAYS} days, {cfg.n_clusters} clusters / {cfg.n_campuses} "
          f"campuses / {cfg.n_zones} zones; kernel rows per launch {rows}; "
          f"params built in {time.perf_counter() - t0:.2f} s", flush=True)

    def drive(c, label):
        marks, checks, backlog, last, bests = {}, [], {}, {}, []

        def on_day(d, state, out):
            torch.cuda.synchronize()
            marks[d] = time.perf_counter()
            if out is None:
                backlog["queue"] = state.queue.sum(-1)
                backlog["state0"] = state
            else:
                checks.append(check_day(d, out))
                last["out"] = out
                if out.best is not None:
                    bests.append(out.best)

        run = sim.rollout_batch(c, MAIN_DAYS, device="cuda", on_day=on_day)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with eager_projections() as eager:
            state, ledger, traj = run(params)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = read_counts()
        routes = dict(pgd_kernel.joint_step_cuda.routes)
        s_proj = pgd_kernel.s_project_cuda.launches
        burn_s, roll_s = marks[-1] - t0, t1 - marks[-1]
        B = len(scenarios) * S
        worst = tuple(max(ch[i] for ch in checks) for i in range(2))
        print(f"[slice] {label}: burn-in {burn_s:.3f} s; rollout "
              f"{roll_s:.3f} s for {MAIN_DAYS} days "
              f"({1e3 * roll_s / MAIN_DAYS:.1f} ms a day); "
              f"{B * MAIN_DAYS / roll_s:.3f} fleet-days/s ({B} fleets of "
              f"{c.n_clusters} clusters); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches of #1 / #2 / #3: {counts[0]} / {counts[1]} / "
              f"{counts[2]} (#3 by route {routes}; s_project "
              f"{s_proj}; eager project_row calls on the card "
              f"{eager['calls']}); worst daily conservation residual "
              f"{worst[0]:.3e}, bound violation {worst[1]:.3e}", flush=True)
        if eager["calls"]:
            raise AssertionError(f"{label}: {eager['calls']} eager "
                                 "projections ran on the card")
        for name, val in list(ledger._asdict().items()) + list(traj.items()):
            if not torch.isfinite(val).all():
                raise AssertionError(f"{label}: non-finite values in {name}")
        if c.joint_spatial:
            RUNS["slice"] = dict(cfg=c, params=params,
                                 state0=backlog["state0"],
                                 out=(state, ledger, traj), names=names,
                                 days=MAIN_DAYS)
        return state, ledger, counts + [routes, s_proj], backlog["queue"], \
            roll_s, last["out"], bests

    state, led_joint, counts, backlog, roll_s, last, bests = drive(
        cfg, "joint")
    steps = MAIN_DAYS * JOINT_ROUNDS * JOINT_STEPS
    want = [MAIN_DAYS * SOLVE_ROUNDS, MAIN_DAYS * SOLVE_ROUNDS, steps, 0, 0,
            {"fused": steps, "split": 0}, 0]
    if counts != want:
        raise AssertionError(f"the slice path launched kernels #1 to #5 "
                             f"(#3 by route, then s_project) {counts} times, "
                             f"expected {want}")
    # printed, not held: the golden-size slice below holds the verdicts
    # (non-zero and equal on both devices)
    kept_days(bests, names, S)
    print(sim.format_table(sim.scenario_rows(
        led_joint, names, S, horizon_days=MAIN_DAYS,
        initial_backlog=backlog)), flush=True)
    _, led_seq, seq_counts, _, _, _, _ = drive(
        slice_config(joint_spatial=False), "sequential (same batch)")
    if seq_counts != [0, MAIN_DAYS * SOLVE_ROUNDS, 0, 0, 0,
                      {"fused": 0, "split": 0}, 0]:
        raise AssertionError(f"the sequential run launched {seq_counts}")

    def sub(led, sl):
        return type(led)(*(x[sl] for x in led))

    mob = slice(0, n_mob * S)
    print(sim.format_table(sim.mobility_sweep_rows(
        sub(led_joint, mob), sub(led_seq, mob), names[:n_mob], S),
        sim.MOBILITY_COLUMNS), flush=True)
    print(sim.format_table(sim.risk_sweep_rows(
        {cfg.n_members: sub(led_joint, slice(n_mob * S, None))},
        names[n_mob:], S), sim.RISK_COLUMNS), flush=True)
    times = joint_step_times(last.prob, last.sol, params)
    wall_ms, busy_ms, _, launches = profile_day(cfg, params, state,
                                                "profile_slice_day.txt")
    day_ms = 1e3 * roll_s / MAIN_DAYS
    print(f"[slice] a day's {JOINT_ROUNDS * JOINT_STEPS} joint steps: "
          f"{times['fused_ms'] * JOINT_ROUNDS * JOINT_STEPS:.1f} ms on the "
          f"fused route, {100 * times['fused_ms'] * JOINT_ROUNDS * JOINT_STEPS / day_ms:.1f}% "
          f"of the unprofiled day ({day_ms:.1f} ms); the eager projection "
          f"off the path would take "
          f"{times['eager_ms'] * JOINT_ROUNDS * JOINT_STEPS:.1f} ms a day; "
          f"the profiled day made {launches} launches", flush=True)
    return counts, roll_s


def joint_step_times(prob, sol, params, reps: int = 3):
    """Host-clock time of a joint step at the slice's shapes, JOINT_STEPS
    steps ended by a synchronize, best of ``reps``: the path's fused route
    (``ops.joint_stepper``: one wrapper call and one launch a step), the
    split route's two launches (the step's kernel and ``s_project`` on the
    same laid-out operands), and, off the path, the eager projection of s
    in PyTorch (``solver.project_conservation``) that the fused route
    replaced."""
    import dataclasses

    from repro_torch.core import solver, spatial
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ops
    p = dataclasses.replace(prob, eta_ens=None, pow_nom_ens=None,
                            risk_beta=None)
    lo_s, ub_s = spatial.shift_bounds(p, params.mobility)
    s = torch.zeros_like(p.tau)
    lr_d = solver.scaled_lr(0.5, p.pi, p.tau, p.eta, p.lambda_e, p.lambda_p)
    temp = solver.peak_temperature(p.pow_nom, 0.02)
    lr_s = torch.full_like(p.lambda_e, 0.01)
    g_s = torch.zeros_like(s)
    step = ops.joint_stepper(p, sol.delta.shape, sol.mu, lo_s, ub_s, lr_d,
                             lr_s, temp)

    def timed(fn):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(JOINT_STEPS):
                fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / JOINT_STEPS)
        return 1e3 * best

    fused_ms = timed(lambda: step(sol.delta, s))
    plan = pgd_kernel.joint_plan
    pgd_kernel.joint_plan = lambda n, block_rows=0: ("split", 0, 0)
    try:     # the same stepper, its wrapper sent down the split route
        split_ms = timed(lambda: step(sol.delta, s))
    finally:
        pgd_kernel.joint_plan = plan
    eager_ms = timed(lambda: solver.project_conservation(
        s - 0.01 * g_s, lo_s, ub_s))
    print(f"[slice] a joint step (host clock, synchronized, best of {reps} "
          f"x {JOINT_STEPS}): fused route {fused_ms:.4f} ms (the path's), "
          f"split route {split_ms:.4f} ms (two launches); off the path, the "
          f"eager s projection alone {eager_ms:.3f} ms", flush=True)
    return {"fused_ms": fused_ms, "split_ms": split_ms, "eager_ms": eager_ms}


@contextmanager
def eager_projections():
    """Counts ``ref.project_row`` calls on CUDA tensors while entered (the
    eager projection, which no joint step on the card may take):
    ``with eager_projections() as c: ...; c["calls"]``."""
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    plain, count = pgd_ref.project_row, {"calls": 0}

    def counted(z, *args, **kw):
        count["calls"] += int(z.is_cuda)
        return plain(z, *args, **kw)

    pgd_ref.project_row = counted
    try:
        yield count
    finally:
        pgd_ref.project_row = plain


# ------------------------------------------------ phase 5b: closed loop

# forecast_bust_library's 3 scenarios x 4 seeds x 512 clusters
CL_DAYS = 7
CL_ROLLOUTS = 3 * len(MAIN_SEEDS)
CL_ROWS = CL_ROLLOUTS * MAIN_CLUSTERS
SUFFIX_ROUNDS, SUFFIX_STEPS = 2, 8     # solve_vcc_suffix's schedule
SUFFIX_HOURS = (1, 12, 23, 24)         # re-solves whose boxes #1 is held at
# the per-rollout state bytes at the closed loop's fleet (512 clusters, 16
# zones, hist_days 35), counted from the leaf shapes: the streaming carry's
# 979 float32 a cluster (usage ring 672, hour-of-week levels 168, rings
# 35 + 28 + 21, the rest 55) against the seven hist_* windows' 3,465 a
# cluster and carbon_hist's 16 x 35 x 24
COUNTED_PRED_BYTES = 979 * 4 * MAIN_CLUSTERS
COUNTED_HIST_BYTES = 3465 * 4 * MAIN_CLUSTERS + 16 * 35 * 24 * 4


def closed_loop_config(**kw):
    from repro_torch import sim
    base = dict(n_clusters=MAIN_CLUSTERS, n_campuses=64, n_zones=16,
                pds_per_cluster=2, hist_days=35, streaming=True)
    return sim.SimConfig(**{**base, **kw})


def phase_closed_loop(card):
    """The paper's closed-loop CICS day at full width: streaming prediction
    with the open loop, then with intra-day MPC recourse, on the same
    forecast-busting batch. Exact launches of #1 (20 a day open, 68
    closed), and every day: finite values, the queue conserved over the
    horizon, the enforced curve's hour 0 the gated plan's, and the day
    solve's conservation and bounds. Then #1 at the closed loop's real
    suffix boxes, the state bytes, the recourse table and a profiled
    closed-loop day. Returns #1's record additions."""
    from repro_torch import sim
    from repro_torch.core import mpc
    scenarios = sim.forecast_bust_library(CL_DAYS)
    names = [sc.name for sc in scenarios]
    S = len(MAIN_SEEDS)
    cfg_open, cfg_closed = closed_loop_config(), closed_loop_config(mpc=True)
    t0 = time.perf_counter()
    params = sim.build_batch(cfg_open, scenarios, MAIN_SEEDS, CL_DAYS)
    torch.cuda.synchronize()
    B = len(scenarios) * S
    if B * cfg_open.n_clusters != CL_ROWS:
        raise AssertionError(f"closed-loop path has {B * MAIN_CLUSTERS} "
                             f"kernel rows, expected {CL_ROWS}")
    print(f"[closed] streaming=True, open loop then mpc=True: "
          f"{len(scenarios)} scenarios ({', '.join(names)}) x {S} seeds, "
          f"{CL_DAYS} days, {cfg_open.n_clusters} clusters / "
          f"{cfg_open.n_campuses} campuses / {cfg_open.n_zones} zones, hist "
          f"{cfg_open.hist_days} days; kernel rows per launch {CL_ROWS}; "
          f"params built in {time.perf_counter() - t0:.2f} s", flush=True)

    def drive(cfg, label):
        marks, checks, prev, sums = {}, [], {}, {}
        spent = [0.0]
        left = [0, 0]       # cluster-hours off the plan, of all
        recourse = []

        def on_day(d, state, out):
            torch.cuda.synchronize()
            marks[d] = time.perf_counter()
            if out is None:
                sums["state0"] = state
                sums["backlog"] = state.queue.double().sum(-1)
                sums["arrived"] = torch.zeros_like(sums["backlog"])
                sums["served"] = torch.zeros_like(sums["backlog"])
            else:
                checks.append(check_day(d, out))
                for name, x in list(out.res.__dict__.items()) + [
                        ("vcc_curve", out.vcc_curve), ("queue", state.queue)]:
                    if not torch.isfinite(x).all():
                        raise AssertionError(f"{label} day {d}: non-finite "
                                             f"{name}")
                sums["arrived"] += out.res.arrived.double().sum(-1)
                sums["served"] += out.res.served.double().sum(-1)
                lhs = sums["backlog"] + sums["arrived"]
                rhs = sums["served"] + state.queue.double().sum(-1)
                if not torch.allclose(lhs, rhs, rtol=1e-4, atol=0):
                    raise AssertionError(
                        f"{label} day {d}: backlog + arrivals "
                        f"{lhs.tolist()} != served + backlog {rhs.tolist()}")
                gate = prev["state"].shaping_allowed & out.sol.shaped
                plan = mpc.gated_curve(out.prob, out.sol.delta, out.prob.tau,
                                       gate, out.prob.capacity)
                if not torch.allclose(out.vcc_curve[..., 0], plan[..., 0],
                                      rtol=1e-6, atol=0):
                    raise AssertionError(f"{label} day {d}: the enforced "
                                         "curve's hour 0 is not the plan's")
                off = (out.vcc_curve - plan).abs() > 1e-6 * plan.abs()
                left[0] += int(off.sum())
                left[1] += off.numel()
                if out.recourse is not None:
                    recourse.append(out.recourse.recourse_frac.mean().item())
            prev["state"] = state
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - marks[d]

        run = sim.rollout_batch(cfg, CL_DAYS, device="cuda", on_day=on_day)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, ledger, traj = run(params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = read_counts()
        burn_s = marks[-1] - t0
        # as the main path counts it (the daily checks included), and
        # without the checks' own time (each callback's, after its mark)
        roll_s = t1 - marks[-1]
        net_s = roll_s - spent[0]
        worst = tuple(max(ch[i] for ch in checks) for i in range(2))
        print(f"[closed] {label}: burn-in {burn_s:.3f} s; rollout "
              f"{roll_s:.3f} s for {CL_DAYS} days "
              f"({1e3 * roll_s / CL_DAYS:.1f} ms a day); "
              f"{B * CL_DAYS / roll_s:.3f} fleet-days/s "
              f"({B * CL_DAYS / net_s:.3f} without the daily checks' "
              f"{1e3 * spent[0]:.0f} ms; {B} fleets of "
              f"{cfg.n_clusters} clusters); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches of #1 to #5 {counts}; worst daily conservation "
              f"residual {worst[0]:.3e}, bound violation {worst[1]:.3e}; "
              f"queue conserved over the horizon to rtol 1e-4; the enforced "
              f"curve left the plan on {left[0]} of {left[1]} cluster-hours "
              f"({100 * left[0] / left[1]:.2f}%)"
              + (f"; mean recourse_frac a day "
                 f"{[round(r, 4) for r in recourse]}" if recourse else ""),
              flush=True)
        for name, val in list(ledger._asdict().items()) + list(traj.items()):
            if not torch.isfinite(val).all():
                raise AssertionError(f"{label}: non-finite values in {name}")
        if cfg.mpc:
            RUNS["closed"] = dict(cfg=cfg, params=params,
                                  state0=sums["state0"],
                                  out=(state, ledger, traj), names=names,
                                  days=CL_DAYS)
        return state, ledger, counts, net_s

    _, led_open, counts_open, open_s = drive(cfg_open, "open loop")
    state, led_closed, counts_closed, closed_s = drive(cfg_closed,
                                                       "closed loop")
    want_open = [CL_DAYS * SOLVE_ROUNDS, 0, 0, 0, 0]
    want_closed = [CL_DAYS * (SOLVE_ROUNDS + 24 * SUFFIX_ROUNDS), 0, 0, 0, 0]
    if counts_open != want_open or counts_closed != want_closed:
        raise AssertionError(f"the closed-loop path launched kernels #1 to #5 "
                             f"{counts_open} (open) and {counts_closed} "
                             f"(closed) times, expected {want_open} and "
                             f"{want_closed}")
    print(f"[closed] the closed loop's day is {closed_s / open_s:.3f}x the "
          "open loop's (without the checks)", flush=True)
    print(sim.format_table(sim.mpc_recourse_rows(led_closed, led_open, names,
                                                 S), sim.MPC_COLUMNS),
          flush=True)
    state_bytes(cfg_open, params, state, B)
    day_ms, loop_ms, captured = timed_closed_day(cfg_closed, params, state)
    print(f"[closed] one closed-loop day (host clock, synchronized): "
          f"{day_ms:.1f} ms, of which the 24-hour recourse loop "
          f"(mpc.mpc_day) {loop_ms:.1f} ms ({100 * loop_ms / day_ms:.1f}%)",
          flush=True)
    suffix = suffix_kernel_checks(captured, card)
    profile_day(cfg_closed, params, state, "profile_closed_loop_day.txt",
                days=CL_DAYS)
    return {"launches_closed_loop": counts_closed[0],
            "launches_open_loop": counts_open[0], **suffix}


def state_bytes(cfg, params, state, B):
    """Per-rollout carried state, streaming against the rescan state of the
    same fleet and hist_days (one rollout burned in for it)."""
    import dataclasses

    from repro_torch import sim
    from repro_torch.core import stages, stats
    one = stages.map_tensors(lambda t: t[:1], params)
    rescan = sim.make_init(dataclasses.replace(cfg, streaming=False),
                           device="cuda")(one)
    pred = stats.predictor_nbytes(state.pred) // B
    hist = stats.replaced_hist_nbytes(rescan) \
        + stats.pytree_nbytes(rescan.carbon_hist)
    print(f"[closed] state a rollout: streaming {sim.state_nbytes(state, B):,}"
          f" B, rescan {sim.state_nbytes(rescan):,} B; the carry `pred` "
          f"{pred:,} B (counted from the leaf shapes: {COUNTED_PRED_BYTES:,}) "
          f"against the seven hist_* windows and carbon_hist {hist:,} B "
          f"(counted: {COUNTED_HIST_BYTES:,})", flush=True)
    if pred != COUNTED_PRED_BYTES or hist != COUNTED_HIST_BYTES:
        raise AssertionError("the state bytes are not the counted ones")


@contextmanager
def timed_suffix_calls(hours):
    """Times ``mpc.mpc_day`` (synchronized) and keeps the arguments of the
    suffix re-solves at ``hours`` while entered."""
    from repro_torch.core import mpc, vcc
    day, solve = mpc.mpc_day, vcc.solve_vcc_suffix
    rec = {"ms": 0.0, "calls": {}}

    def timed_day(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = day(*a, **kw)
        torch.cuda.synchronize()
        rec["ms"] += 1e3 * (time.perf_counter() - t0)
        return out

    def kept_solve(p, delta0, mu0, hour, **kw):
        if hour in hours:
            rec["calls"][hour] = (p, delta0.clone(), mu0.clone())
        return solve(p, delta0, mu0, hour, **kw)

    mpc.mpc_day, vcc.solve_vcc_suffix = timed_day, kept_solve
    try:
        yield rec
    finally:
        mpc.mpc_day, vcc.solve_vcc_suffix = day, solve


def timed_closed_day(cfg, params, state):
    """One more closed-loop day on the host clock: its wall ms and the
    24-hour loop's; and the suffix problems at ``SUFFIX_HOURS``."""
    from repro_torch import sim
    from repro_torch.sim import engine
    step = sim.make_day_step(cfg)
    xs = engine.day_xs(params, CL_DAYS - 1)
    step(params, state, xs)          # warm
    with timed_suffix_calls(SUFFIX_HOURS) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, xs)
        torch.cuda.synchronize()
        day_ms = 1e3 * (time.perf_counter() - t0)
    return day_ms, rec["ms"], rec["calls"]


def suffix_kernel_checks(captured, card):
    """Kernel #1 at the closed loop's real suffix boxes against its plain
    version on the same operands. The epoch as the path runs it (8 steps):
    the elapsed columns and the fully pinned (infeasible) rows come back as
    ``delta_committed`` bit for bit on both, and the kernel's point is
    feasible. Each of its 8 steps, one launch at a time along the kernel's
    own trajectory, within KERNEL_TOL of the plain step: the kernel's own
    error. The 8-step gap is printed beside the plain version's own gap
    between the card and the CPU, and its own gap when the prices move
    one ulp: these boxes' descent (large carried campus duals, a sharp
    softmax peak) amplifies a step's rounding several times a step, so the
    epochs' gap measures the conditioning, not the kernel. One suffix epoch
    timed at the path's rows."""
    from repro_torch.core import solver, vcc
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    out = {}
    for hour in SUFFIX_HOURS:
        p, delta0, mu0 = captured[hour]
        lo, ub, feasible = vcc.suffix_bounds(p, delta0, hour)
        shape = delta0.shape
        H = shape[-1]

        def flat(x, k):
            return torch.as_tensor(x, dtype=torch.float32).expand(
                shape[:-1] + (k,)).reshape(-1, k).contiguous()

        price = p.lambda_p[..., None] + torch.gather(mu0, -1, p.campus)
        lr = solver.scaled_lr(0.5, p.pi, p.tau, p.eta, p.lambda_e,
                              p.lambda_p)
        args = [flat(x, H) for x in (delta0, p.eta, p.pi, p.pow_nom)] \
            + [flat(p.tau[..., None] / 24.0, 1), flat(price[..., None], 1),
               flat(lo, H), flat(ub, H), flat(lr, 1)]
        temp = flat(solver.peak_temperature(p.pow_nom, 0.02)[..., None,
                                                              None], 1)
        lame = flat(p.lambda_e[..., None, None], 1)

        def kern(d=args[0], iters=SUFFIX_STEPS):
            return pgd_kernel.pgd_epoch_cuda(d, *args[1:], temp, lame,
                                             iters=iters)

        def plain(d=args[0], iters=SUFFIX_STEPS, on=None):
            a = [x if on is None else x.to(on) for x in
                 [d, *args[1:], temp, lame]]
            return pgd_ref.pgd_epoch_ref(*a[:9], temp=a[9], lambda_e=a[10],
                                         iters=iters)

        got, want = kern(), plain()
        cpu = plain(on="cpu")
        torch.cuda.synchronize()
        d0, rows = args[0], args[0].shape[0]
        pinned = (torch.arange(H, device=d0.device) < hour)[None, :] \
            | ~feasible.reshape(-1, 1)
        pinned = pinned.expand_as(d0)
        for name, x in (("kernel", got), ("plain", want)):
            if not torch.equal(x[pinned], d0[pinned]):
                raise AssertionError(f"suffix hour {hour}: the {name}'s "
                                     "pinned entries moved")
        # the rows pinned whole do not conserve: their prefix cannot
        free = feasible.reshape(-1)
        resid, viol = conservation(got[free], args[6][free], args[7][free]) \
            if free.any() else (0.0, 0.0)
        feasible_or_raise("vcc_pgd_epoch (suffix)", rows, got, args[6],
                          args[7], resid, viol)
        # the kernel's own error: one step at a time on its trajectory
        step_err, d = 0.0, d0
        for _ in range(SUFFIX_STEPS):
            nxt = kern(d, 1)
            step_err = max(step_err, (nxt - plain(d, 1)).abs().max().item())
            d = nxt
        err = (got - want).abs().max().item()
        spread = (want.cpu() - cpu).abs().max().item()
        # the descent's own amplification: the plain version again, with
        # the prices one ulp up (the campus duals' last bit)
        nudged = list(args)
        nudged[5] = torch.nextafter(args[5], torch.full_like(args[5], 1e9))
        amp = (pgd_ref.pgd_epoch_ref(*nudged, temp=temp, lambda_e=lame,
                                     iters=SUFFIX_STEPS) - want
               ).abs().max().item()
        print(f"[closed] #1 at the suffix box of hour {hour} ({rows} rows, "
              f"{int((~feasible).sum())} rows pinned whole, {hour} columns "
              f"elapsed): pinned entries bit for bit delta_committed on the "
              f"kernel and the plain version; conservation "
              f"{resid:.3e}, bound violation {viol:.3e}; one step on the "
              f"kernel's trajectory, worst of {SUFFIX_STEPS}: "
              f"max|kernel-plain| {step_err:.3e} (limit {KERNEL_TOL:g}); "
              f"the {SUFFIX_STEPS}-step epoch: max|kernel-plain| {err:.3e}, "
              f"the plain version's own card-vs-CPU gap {spread:.3e}, and "
              f"its gap when the prices move one ulp {amp:.3e}; "
              f"{SUFFIX_STEPS} single-step launches "
              f"{'equal' if torch.equal(d, got) else 'differ from'} the "
              f"epoch's one launch bit for bit", flush=True)
        if not step_err <= KERNEL_TOL:
            raise AssertionError(f"suffix hour {hour}: a kernel step "
                                 "disagrees with the plain step")
        if hour == 12:
            ms, plain_ms = cuda_ms(kern, lead=True), cuda_ms(plain)
            bound_ms, by, _, _ = card.bound(
                pgd_kernel.epoch_flops(rows, H, SUFFIX_STEPS),
                pgd_kernel.epoch_bytes(rows, H))
            print(f"[closed] one suffix epoch ({SUFFIX_STEPS} steps, {rows} "
                  f"rows): kernel {ms:.4f} ms (device), plain {plain_ms:.4f}"
                  f" ms; bound {bound_ms:.4f} ms by {by}", flush=True)
            out.update(suffix_epoch_ms=ms, suffix_plain_ms=plain_ms,
                       suffix_bound_ms=bound_ms, suffix_bound_by=by,
                       suffix_rows=rows, suffix_step_max_abs_err=step_err,
                       suffix_epoch_max_abs_err=err)
    return out


# ------------------------------------------------- phase 5c: telemetry

TEL_REPS = 3                          # off/on rollout pairs timed a path
# the 0/1 gauges of a trace record: the 0/1 entries a cluster's value
# averages (tests/test_torch_telemetry_rollout.py's classes)
TEL_GAUGES = {"theta_coverage": 1, "paused_frac": 1, "shaped_frac": 1,
              "uifq_coverage": 24, "vcc_binding_frac": 24,
              "mpc_recourse_frac": 24}
TEL_RATE = ("obj_first", "obj_final", "uif_mape", "uif_bias",
            "proj_tol_max", "cvar_tail_max")
TEL_ADMITTED = ("queue_age_max", "tuf_mape", "tuf_bias", "tr_mape",
                "tr_bias", "fc_level_drift", "obj_decrease_pct",
                "mpc_recourse_depth")


def tel_expected(path):
    """Launches of #1, #2, #3 (and #3 by route) a path's 7-day run makes."""
    if path == "slice":
        steps = MAIN_DAYS * JOINT_ROUNDS * JOINT_STEPS
        return [MAIN_DAYS * SOLVE_ROUNDS, MAIN_DAYS * SOLVE_ROUNDS, steps,
                {"fused": steps, "split": 0}]
    per_day = SOLVE_ROUNDS + (24 * SUFFIX_ROUNDS if path == "closed" else 0)
    return [MAIN_DAYS * per_day, 0, 0, {"fused": 0, "split": 0}]


def tel_rollout(run, telemetry, outs=None):
    """One run of a path's rollout from its burned-in state, with or
    without telemetry; ``outs`` collects the days' StepOuts. Returns the
    result and the launches of #1-#3 (and #3 by route)."""
    import dataclasses

    from repro_torch import sim
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    cfg = dataclasses.replace(run["cfg"], telemetry=telemetry)
    on_day = None if outs is None else \
        (lambda d, s, o: o is not None and outs.append(o))
    roll = sim.make_rollout(cfg, run["days"], on_day=on_day)
    reset_counts()
    result = roll(run["params"], run["state0"])
    torch.cuda.synchronize()
    return result, read_counts()[:3] + [dict(
        pgd_kernel.joint_step_cuda.routes)]


def leaves(tree):
    from repro_torch.core import stages
    out = []
    stages.map_tensors(out.append, tree)
    return out


def tel_record_checks(path, tel, outs):
    """On the card: every leaf finite and (B, days, ...), the gauges'
    ranges (tests/test_telemetry.py's), ``joint_winner`` the day's
    ``StepOut.best.take``, the recourse gauges ``StepOut.recourse``."""
    B = outs[0].res.served.shape[0]
    for name, leaf in tel._asdict().items():
        if leaf.shape[:2] != (B, len(outs)) or not torch.isfinite(
                leaf).all():
            raise AssertionError(f"[telemetry] {path}: {name} of shape "
                                 f"{tuple(leaf.shape)} or not finite")
    for leaf in (tel.uifq_coverage, tel.vcc_binding_frac, tel.theta_covered,
                 tel.paused, tel.shaped, tel.mpc_recourse_frac):
        if not ((leaf >= 0).all() and (leaf <= 1).all()):
            raise AssertionError(f"[telemetry] {path}: a gauge out of [0, 1]")
    for leaf in (tel.uif_mape, tel.tuf_mape, tel.tr_mape, tel.queue_age_days,
                 tel.fc_level_drift, tel.proj_nu_tol, tel.dual_resid,
                 tel.cvar_tail_mass, tel.mpc_recourse_depth):
        if not (leaf >= 0).all():
            raise AssertionError(f"[telemetry] {path}: a channel below 0")
    for d, o in enumerate(outs):
        take = torch.zeros(B, dtype=torch.bool, device=o.res.served.device) \
            if o.best is None else o.best.take
        if not torch.equal(tel.joint_winner[:, d], take.to(torch.float32)):
            raise AssertionError(f"[telemetry] {path} day {d}: joint_winner "
                                 "is not StepOut.best.take")
        rec = (torch.zeros_like(tel.mpc_recourse_frac[:, d]),) * 2 \
            if o.recourse is None else o.recourse
        if not (torch.equal(tel.mpc_recourse_frac[:, d], rec[0])
                and torch.equal(tel.mpc_recourse_depth[:, d], rec[1])):
            raise AssertionError(f"[telemetry] {path} day {d}: the recourse "
                                 "gauges are not StepOut.recourse")


def tel_trace(path, run, tel):
    """The records to chiprun_out/telemetry_<path>.jsonl and back, the
    per-scenario table; on the slice path the CVaR tail over 8 members."""
    from repro_torch import sim
    S = len(MAIN_SEEDS)
    records = sim.telemetry_records(tel, run["names"], S)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    fname = out / f"telemetry_{path}.jsonl"
    sim.write_jsonl(fname, records)
    if sim.read_jsonl(fname) != json.loads(json.dumps(records)):
        raise AssertionError(f"[telemetry] {path}: {fname.name} does not "
                             "read back equal")
    if tuple(records[0]) != sim.TRACE_FIELDS:
        raise AssertionError(f"[telemetry] {path}: the records' fields")
    print(f"[telemetry] {path}: {len(records)} records to "
          f"chiprun_out/{fname.name}, read back equal; per scenario:",
          flush=True)
    print(sim.format_table(sim.telemetry_rows(records, run["names"]),
                           sim.TELEMETRY_COLUMNS), flush=True)
    if path == "slice":
        tail = [r["cvar_tail_max"] for r in records]
        print(f"[telemetry] slice: cvar_tail_max over the records "
              f"{min(tail):.4f} to {max(tail):.4f} (K = {SLICE_MEMBERS}: "
              f"limits 1/{SLICE_MEMBERS} and 1)", flush=True)
        if not (min(tail) >= 1 / SLICE_MEMBERS - 1e-6 and max(tail) <= 1):
            raise AssertionError("[telemetry] slice: cvar_tail_max outside "
                                 f"[1/{SLICE_MEMBERS}, 1]")
    return records


def tel_overhead(path, run):
    """Day ms with telemetry off and on, each the median of TEL_REPS
    rollouts from the burned-in state (alternated, host clock, after a
    synchronize); and one profiled day each way: the launches telemetry
    adds a day."""
    import dataclasses

    from repro_torch import sim
    from repro_torch.sim import engine
    days = {False: [], True: []}
    for _ in range(TEL_REPS):
        for tel in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tel_rollout(run, tel)
            days[tel].append(1e3 * (time.perf_counter() - t0) / run["days"])
    off, on = (statistics.median(days[t]) for t in (False, True))
    xs = engine.day_xs(run["params"], 0)
    counts = {}
    for tel in (False, True):
        step = sim.make_day_step(dataclasses.replace(run["cfg"],
                                                     telemetry=tel))
        counts[tel] = profile_call(
            lambda: step(run["params"], run["state0"], xs),
            f"profile_telemetry_{path}_{'on' if tel else 'off'}.txt",
            f"{path} day, telemetry {'on' if tel else 'off'}")[3]
    print(f"[telemetry] {path} overhead: a day {off:.1f} ms off, {on:.1f} "
          f"ms on (median of {TEL_REPS} rollouts each: off "
          f"{[round(x, 1) for x in days[False]]}, on "
          f"{[round(x, 1) for x in days[True]]}), {100 * (on - off) / off:+.1f}%"
          f"; a profiled day {counts[False]} launches off, {counts[True]} on "
          f"({counts[True] - counts[False]:+d})", flush=True)
    return off, on, counts[True] - counts[False]


def phase_telemetry():
    """Every path again with telemetry=True from the state its
    telemetry-off run started from: the same states, ledgers and traj bit
    for bit, the same launches of #1-#3; the record checked on the card,
    exported and tabled; the overhead; the stage profiler on the main and
    closed-loop states, the set-up profiler on the closed-loop fleets; a
    fleet day through ``core.fleet``."""
    from repro_torch import sim
    print("[telemetry] each path's off and on runs from its burned-in state, "
          "with PyTorch's default algorithms (the campus sums add in a "
          "fixed order)", flush=True)
    for path in ("main", "slice", "closed"):
        run = RUNS[path]
        off, c_off = tel_rollout(run, False)
        outs = []
        on, c_on = tel_rollout(run, True, outs)
        tel = on[2].pop("telemetry")
        a, b = leaves(off), leaves(on)
        same = len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
        first = leaves(run["out"])
        repeat = len(first) == len(a) and all(
            torch.equal(x, y) for x, y in zip(first, a))
        gap = max(((x.double() - y.double()).abs().max().item()
                   / max(y.double().abs().max().item(), 1e-30)
                   if x.is_floating_point() else float((x != y).any()))
                  for x, y in zip(first, a) if x.numel())
        want = tel_expected(path)
        print(f"[repeat] {path}: the path's {run['days']}-day rollout run "
              f"again from its burned-in state, no deterministic flag: "
              f"states / ledgers / traj ({len(a)} tensors) bit for bit the "
              f"first run's: {repeat} (largest gap relative to the largest "
              f"value {gap:.3e})", flush=True)
        print(f"[telemetry] {path}: off vs on, states / ledgers / traj "
              f"({len(a)} tensors) bit for bit: {same}; launches of #1 / #2 "
              f"/ #3 (#3 by route) off {c_off}, on {c_on}, expected {want}",
              flush=True)
        if not repeat:
            raise AssertionError(f"[repeat] {path}: two runs of the same "
                                 "rollout differ")
        if not same:
            raise AssertionError(f"[telemetry] {path}: telemetry changed the "
                                 "run")
        if c_off != want or c_on != want:
            raise AssertionError(f"[telemetry] {path}: launches {c_off} / "
                                 f"{c_on}, expected {want}")
        tel_record_checks(path, tel, outs)
        tel_trace(path, run, tel)
        tel_overhead(path, run)
    for path in ("main", "closed"):
        run = RUNS[path]
        state = run["out"][0]
        rows = sim.profile_stages(run["cfg"].stage_config(), run["params"],
                                  state)
        print(f"[telemetry] profile_stages on the {path} path's state "
              f"(after its {run['days']} days; one day's spans by path, "
              "host ms; launches of #1 / #2 / #3 / s_project inside each):",
              flush=True)
        print(sim.format_stage_table(rows), flush=True)
    run = RUNS["closed"]
    _, rows = sim.profile_setup(run["cfg"], run["params"])
    print("[telemetry] profile_setup on the closed-loop path: its burn-in "
          "and a one-day warm-up, recorded (the kernels were loaded earlier "
          "in this process, so no build span):", flush=True)
    print(sim.format_stage_table(rows), flush=True)
    paths = {r["path"] for r in rows}
    if not {"burn_in/contracts", "burn_in/predictor_init",
            "rollout/day/observe/observe_mpc"} <= paths:
        raise AssertionError(f"[telemetry] profile_setup's spans: {paths}")
    phase_fleet()


FLEET_DAYS = 2


def phase_fleet():
    """``core.fleet`` at full width: ``init_fleet`` (91 days of burn-in) and
    two ``day_cycle``s on the card, against the engine's burn-in and day
    steps of the same fleet (a one-rollout batch), bit for bit."""
    from repro_torch import sim
    from repro_torch.core import fleet
    from repro_torch.sim import engine
    fcfg = fleet.FleetConfig(n_clusters=MAIN_CLUSTERS, n_campuses=64,
                             n_zones=16, pds_per_cluster=2, telemetry=True)
    scfg = sim.SimConfig(n_clusters=MAIN_CLUSTERS, n_campuses=64, n_zones=16,
                         pds_per_cluster=2, hist_days=fcfg.hist_days,
                         telemetry=True)
    t0 = time.perf_counter()
    st = fleet.init_fleet(fcfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = sim.build_batch(scfg, [sim.Scenario(
        "fleet", lambda_e=fcfg.lambda_e, lambda_p=fcfg.lambda_p,
        gamma=fcfg.gamma)], [fcfg.seed], FLEET_DAYS)
    state = sim.make_init(scfg)(params)
    for k in ("hist_uif", "hist_usage", "carbon_hist", "campus_limit",
              "queue"):
        if not torch.equal(getattr(st, k), getattr(state, k)[0]):
            raise AssertionError(f"[fleet] init_fleet's {k} is not the "
                                 "engine's")
    step = sim.make_day_step(scfg)
    for d in range(FLEET_DAYS):
        reset_counts()
        rec = {}
        t2 = time.perf_counter()
        st = fleet.day_cycle(st, rec)
        torch.cuda.synchronize()
        day_ms = 1e3 * (time.perf_counter() - t2)
        launches = read_counts()
        state, out = step(params, state, engine.day_xs(params, d))
        got = leaves((rec["fc"], rec["sol"].__dict__, rec["vcc"],
                      rec["result"].__dict__, rec["cf_result"].__dict__,
                      rec["intensity"], rec["telemetry"],
                      rec["problem"].__dict__))
        want = leaves((out.fc, out.sol.__dict__, out.vcc_curve,
                       out.res.__dict__, out.cf.__dict__, out.eta_act,
                       out.telemetry, out.prob.__dict__))
        if len(got) != len(want) or not all(
                torch.equal(x, y[0]) for x, y in zip(got, want)):
            raise AssertionError(f"[fleet] day {d}: day_cycle's record is "
                                 "not the engine step's")
        for k in ("queue", "cf_queue", "hist_usage", "campus_limit"):
            if not torch.equal(getattr(st, k), getattr(state, k)[0]):
                raise AssertionError(f"[fleet] day {d}: state {k}")
        line = sim.telemetry_records(sim.DayTelemetry(
            *(x[None, None] for x in rec["telemetry"])), ["fleet"], 1)[0]
        print(f"[fleet] day {st.day}: day_cycle {day_ms:.1f} ms (host "
              f"clock), launches of #1 to #5 {launches} (expected "
              f"[{SOLVE_ROUNDS}, 0, 0, 0, 0]); record and state equal "
              f"the engine's step bit for bit; trace line "
              f"{json.dumps(line)}", flush=True)
        if launches != [SOLVE_ROUNDS, 0, 0, 0, 0]:
            raise AssertionError(f"[fleet] day {d}: launches {launches}")
    print(f"[fleet] init_fleet ({fcfg.n_clusters} clusters / "
          f"{fcfg.n_campuses} campuses / {fcfg.n_zones} zones, "
          f"{fcfg.hist_days} days of burn-in) {t1 - t0:.2f} s, equal to the "
          f"engine's burn-in bit for bit", flush=True)


# ------------------------------------------------- phase 6: serving path

SERVE_ARCHS = ("zamba2-7b", "qwen3-0.6b", "rwkv6-7b", "deepseek-moe-16b",
               "internvl2-2b", "whisper-base", "deepseek-v2-236b", "yi-6b",
               "gemma2-9b", "deepseek-67b")
CONSISTENCY_TOL = 5e-2                # decode vs prefill, x max|logit|, bf16
FLOAT32_CONSISTENCY_TOL = 1e-4        # the same in float32 (serving's golden)
DISPATCH_TOL = 1e-4                   # scatter vs einsum, x max|logit|
# DeepSeek-V2-236B at its published widths, cut to 8 of 60 layers (the
# dense first layer and 7 MoE layers: 29.2 B parameters, 54.4 GiB in
# bf16; the whole model's 235.7 B would take 440 GiB); its float32 checks
# at the dense layer and one MoE layer (5.36 B parameters, 20 GiB)
# DeepSeek-67B at its published widths, cut to 32 of 95 layers: 0.692 B
# parameters a layer (attention 151 M: q and o 8,192^2 each, k and v
# 8,192 x 1,024 each; the SwiGLU MLP 3 x 8,192 x 22,016 = 541 M) and
# 1.678 B of embedding and untied head (2 x 102,400 x 8,192), 23.8 B
# parameters, ~44 GiB in bf16; the whole model's 67.4 B would take ~126 GiB
SERVE_LAYERS = {"deepseek-v2-236b": 8, "deepseek-67b": 32}
FLOAT32_LAYERS = {"deepseek-v2-236b": 2}


def no_drop_capacity(m):
    """The least whole capacity factor at which every expert has a slot for
    each token of its group (C >= S), so that no prefill can drop: an MoE
    model's decode-vs-prefill check runs there, as
    tests/test_decode_consistency.py:20-22 raises the smoke configs' to
    8.0 (at the published 1.25 the reference's own prefill drops tokens
    that its no_drop decode keeps)."""
    return float(math.ceil(m.num_experts / m.top_k))


def serve_shape(arch, cfg):
    """(prompt tokens, the prompt's first position, cache slots) of the
    serving path's calls: a VLM's prompt follows its vision positions,
    Whisper's prompts are SERVE_PROMPTS' 128 tokens, and ``serve`` sizes
    the cache to the prompt's end plus SERVE_GEN + 8."""
    from repro_torch.models.model import prompt_start
    prompt = SERVE_PROMPTS.get(arch, SERVE_PROMPT)
    start = prompt_start(cfg)
    return prompt, start, start + prompt + SERVE_GEN + 8


def serve_inputs(cfg, toks):
    """A prefill's batch: the tokens and the stub frontends' zeros."""
    from repro_torch.models.model import stub_inputs
    return {"tokens": toks, **stub_inputs(cfg, toks.shape[0], toks.device)}


def launches_per_call(cfg):
    """Launches of (#4, #5) in one prefill and in one decoded token: Zamba2
    runs the scan once a Mamba2 layer in a prefill and its shared block
    once a group in both; RWKV6 the scan once a layer in a prefill and
    nothing in decode (its step is plain); an encoder-decoder attention
    once an encoder layer and twice a decoder layer (self and cross) in a
    prefill, twice a decoder layer in decode; an MLA model attention once
    a layer in a prefill and nothing in decode (its absorbed step over the
    latent cache is plain); a dense, MoE or VLM model attention once a
    layer in both."""
    if cfg.mla is not None:
        return (cfg.num_layers, 0), (0, 0)
    if cfg.family == "encdec":
        return (cfg.encoder_layers + 2 * cfg.num_layers, 0), \
            (2 * cfg.num_layers, 0)
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        return (groups, cfg.num_layers), (groups, 0)
    if cfg.family == "ssm":
        return (0, cfg.num_layers), (0, 0)
    return (cfg.num_layers, 0), (cfg.num_layers, 0)


def gla_route_of(cfg):
    """The route of #5 a bf16 model's scans take: Mamba2's scalar decay the
    tensor-core ``gla_ssd``, RWKV6's per-channel decay, bonus and strict
    mode the tensor-core ``gla_vec``."""
    return "gla_vec" if cfg.family == "ssm" else "gla_ssd"


def phase_serve():
    """Carbon-aware serving at full published width on the card: the seven
    models (DeepSeek-V2 at SERVE_LAYERS' depth), exact launch counts (#4's
    and #5's by route too), a decode-vs-prefill check, a profiled prefill
    and decode step of Zamba2, RWKV6, DeepSeekMoE, InternVL2, Whisper and
    DeepSeek-V2, the MoE models' routing checks (``moe_serve_checks``) and
    their float32 checks (``moe_float32_checks``). Returns the launches of #4 and #5, their calls
    by route, #5's calls by model and route, and #4's launches by
    model."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    totals, routes, gla_routes, gla_by_model = [0, 0], {}, {}, {}
    fa_by_model = {}
    for arch in SERVE_ARCHS:
        cfg = get_arch(arch).config.replace(remat="none")
        full_depth = cfg.num_layers
        cfg = cfg.replace(num_layers=SERVE_LAYERS.get(arch, full_depth))
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, "cuda", seed=0)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[serve] {arch}: {type(model).__name__}, "
              f"{n_params / 1e9:.3f} B parameters "
              f"({cfg.dtype}, {cfg.num_layers} of {full_depth} layers, "
              f"d_model {cfg.d_model}), built on the card from seed 0 in "
              f"{time.perf_counter() - t0:.2f} s; weights "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while "
              f"built)", flush=True)
        prompt = serve_shape(arch, cfg)[0]
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res = serve(arch, batch=SERVE_BATCH, prompt_len=prompt,
                    gen=SERVE_GEN, rounds=SERVE_ROUNDS, carbon_aware=True,
                    device="cuda", model=model)
        counts = read_counts()
        by_route = dict(fa_kernel.flash_attention_cuda.routes)
        gla_by_route = dict(gla_kernel.gla_cuda.routes)
        peak = torch.cuda.max_memory_allocated() / 2**30
        pre, tok = launches_per_call(cfg)
        want = [SERVE_ROUNDS * (p + SERVE_GEN * t) for p, t in zip(pre, tok)]
        print(f"[serve] {arch}: admitted batch per round {res.batches}; "
              f"prefill ms per round "
              f"{', '.join(f'{x:.1f}' for x in res.prefill_ms)}; decode ms "
              f"per token per round "
              f"{', '.join(f'{x:.2f}' for x in res.decode_ms)}; "
              f"{res.tokens_per_s:.1f} tokens/s over {res.seconds:.2f} s "
              f"(first round included); peak device memory {peak:.2f} GiB; "
              f"launches of #4 / #5: {counts[3]} / {counts[4]} (expected "
              f"{want[0]} / {want[1]}: {pre[0]} / {pre[1]} per prefill, "
              f"{tok[0]} / {tok[1]} per token)", flush=True)
        if counts != [0, 0, 0, *want]:
            raise AssertionError(f"{arch}: serving launched kernels #1 to #5 "
                                 f"{counts} times, expected "
                                 f"{[0, 0, 0, *want]}")
        # bf16 prefills take the tensor-core route, decode steps split-KV
        want_routes = {"flash_prefill": SERVE_ROUNDS * pre[0],
                       "flash_decode": SERVE_ROUNDS * SERVE_GEN * tok[0],
                       "flash_attention": 0}
        print(f"[serve] {arch}: #4 calls by route {by_route} (expected "
              f"{want_routes})", flush=True)
        if by_route != want_routes:
            raise AssertionError(f"{arch}: #4 routes {by_route}, expected "
                                 f"{want_routes}")
        for r, n in by_route.items():
            routes[r] = routes.get(r, 0) + n
        # bf16 Mamba2 prefills take gla_ssd, RWKV6's gla_vec
        want_gla = dict.fromkeys(gla_kernel.SOURCES, 0)
        want_gla[gla_route_of(cfg)] = want[1]
        print(f"[serve] {arch}: #5 calls by route {gla_by_route} (expected "
              f"{want_gla})", flush=True)
        if gla_by_route != want_gla:
            raise AssertionError(f"{arch}: #5 routes {gla_by_route}, "
                                 f"expected {want_gla}")
        for r, n in gla_by_route.items():
            gla_routes[r] = gla_routes.get(r, 0) + n
        if want[1]:
            gla_by_model[arch] = gla_by_route
        for r, toks in enumerate(res.tokens):
            if toks.shape != (res.batches[r], SERVE_GEN + 1) or not (
                    (toks >= 0) & (toks < cfg.vocab_size)).all():
                raise AssertionError(f"{arch}: round {r} tokens malformed")
        totals[0] += counts[3]
        totals[1] += counts[4]
        if counts[3]:
            fa_by_model[arch] = counts[3]
        if cfg.mla is not None:
            latent_cache_bytes(arch, model)
        windowed_calls(arch, model)
        if cfg.moe:
            moe_serve_checks(arch, cfg, model, res)
        else:
            decode_consistency(arch, cfg, model)
        if cfg.family in ("hybrid", "ssm"):
            profile_prefill(arch, model, res.prefill_ms)
            profile_decode(arch, model)
        elif cfg.family in ("vlm", "encdec") or local_global(cfg):
            # a windowed model's long prompt: #4's share of its prefill
            # and decode (Gemma2's decode also makes a float32 copy of its
            # tied 256,000-row head a step)
            profile_prefill(arch, model, res.prefill_ms, which="#4")
            profile_decode(arch, model, which="#4")
        del model
        torch.cuda.empty_cache()
        if cfg.moe:
            moe_float32_checks(arch, cfg.replace(
                num_layers=FLOAT32_LAYERS.get(arch, cfg.num_layers)))
    return totals, routes, gla_routes, gla_by_model, fa_by_model


def local_global(cfg):
    """Whether a config alternates local (windowed) and global layers."""
    return cfg.attn is not None and cfg.attn.pattern == "local_global"


def windowed_calls(arch, model, prompt=None, gen=SERVE_GEN, tag="[serve]"):
    """For a model with local layers (Gemma2's even layers), how many of a
    prefill's queries and which decode positions see a key span cut by the
    window, at ``prompt`` tokens (default the serving prompt) and ``gen``
    decoded tokens; raises if the window binds nowhere. Prints nothing
    for a model without a window."""
    cfg = model.cfg
    if not local_global(cfg):
        return
    from repro_torch.models.attention import GLOBAL_WINDOW
    W = cfg.attn.window
    T, start, _ = serve_shape(arch, cfg)
    T = T if prompt is None else prompt
    wins = model.windows()
    n_local = sum(w == W for w in wins)
    n_global = sum(w == GLOBAL_WINDOW for w in wins)
    # a query at position p attends keys (p - W, p]: the window cuts its
    # span once p >= W
    queries = max(0, start + T - max(W, start))
    decode = [p for p in range(start + T, start + T + gen) if p >= W]
    print(f"{tag} {arch}: window {W} on {n_local} local layers, "
          f"GLOBAL_WINDOW ({GLOBAL_WINDOW}) on {n_global} global layers; "
          f"under the window: {queries} of each prompt's {T} prefill queries "
          f"(positions {max(W, start)}..{start + T - 1}) and {len(decode)} of "
          f"{gen} decode positions"
          + (f" ({decode[0]}..{decode[-1]})" if decode else "")
          + "; the global layers attend the whole prefix", flush=True)
    if not (n_local and n_global and queries and len(decode) == gen):
        raise AssertionError(f"{arch}: the window does not bind")


def latent_cache_bytes(arch, model):
    """An MLA model's decode cache at the serving shape (the latent ckv
    and krope of every layer), beside the K and V an expanded cache of
    the same heads would hold."""
    cfg = model.cfg
    _, _, max_seq = serve_shape(arch, cfg)
    cache = model.init_cache(SERVE_BATCH, max_seq)
    got = sum(t.nbytes for c in cache.values() for t in c.values())
    a, m = cfg.attn, cfg.mla
    per = m.kv_lora_rank + m.rope_head_dim
    expanded = (a.num_heads * (m.nope_head_dim + m.rope_head_dim
                               + m.v_head_dim))
    print(f"[serve] {arch}: latent cache {got} bytes ({SERVE_BATCH} x "
          f"{max_seq} slots x {cfg.num_layers} layers x {per} values, "
          f"{cfg.dtype}); an expanded K and V of {a.num_heads} heads "
          f"would hold {expanded} values a position and layer, "
          f"{expanded / per:.1f}x as many", flush=True)
    del cache


def decode_consistency(arch, cfg, model, B=2, tol=CONSISTENCY_TOL):
    """The logits of a decode step after prefilling T - 1 tokens against
    the prefill of all T tokens (T the arch's serving prompt; a VLM's
    vision prefix and an encoder-decoder's frames, the stubs' zeros, in
    both prefills, the decode position after the vision prefix; no plain
    path runs), in the model's type, held within ``tol`` of max|logit|
    (``tol=None``: printed, not held). Returns the gap."""
    T, start, _ = serve_shape(arch, cfg)
    g = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                         device="cuda")
    with torch.inference_mode():
        _, cache = model.prefill(serve_inputs(cfg, toks[:, :-1]),
                                 start + T + 8)
        dec, _ = model.decode_step(cache, toks[:, -1], start + T - 1)
        full, _ = model.prefill(serve_inputs(cfg, toks), start + T + 8)
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        raise AssertionError(f"{arch}: non-finite logits")
    gap = (dec - full).abs().max().item() / full.abs().max().item()
    print(f"[serve] {arch}: decode step at position {start + T - 1} after a "
          f"{T - 1}-token prefill vs the {T}-token prefill ({cfg.dtype}"
          + (f", {start} vision positions first" if start else "")
          + "): max|logit gap| / max|logit| "
          f"= {gap:.3e} ("
          + ("not held here" if tol is None else f"limit {tol:g}")
          + f"); logits {tuple(full.shape)}, finite", flush=True)
    if tol is not None and not gap <= tol:
        raise AssertionError(f"{arch}: decode vs prefill gap {gap:.3e}")
    return gap


GLA_KERNELS = ("gla_ssd_kernel", "gla_vec_kernel", "gla_scan_kernel")
FLASH_KERNELS = ("flash_prefill_bf16_kernel", "flash_decode_split_kernel",
                 "flash_decode_combine_kernel", "flash_attention_kernel")
# the kernel whose share of a profiled prefill or decode step is printed
PROFILED = {"#4": FLASH_KERNELS, "#5": GLA_KERNELS}


def kernel_share(arch, what, which, ours, busy_ms, wall_ms):
    """Kernel ``which``'s device ms in a profiled call, and its share of
    the busy time and of the wall."""
    ms = sum(ours.get(k, 0.0) for k in PROFILED[which])
    print(f"[profile] {arch} {what}: kernel {which} {ms:.2f} ms of the "
          f"device's {busy_ms:.1f} busy ms ({100 * ms / busy_ms:.1f}%), "
          f"{100 * ms / wall_ms:.1f}% of the profiled wall {wall_ms:.1f} ms; "
          f"the device busy {100 * busy_ms / wall_ms:.1f}% of it", end="",
          flush=True)


def profile_prefill(arch, model, prefill_ms, B=SERVE_BATCH, which="#5"):
    """One prefill of the serving shape under torch.profiler, after a warm
    one: the device's busy share and kernel ``which``'s share of it (table
    in chiprun_out/profile_serve_prefill.txt for Zamba2-7B,
    profile_serve_prefill_<arch>.txt for the others)."""
    prompt, _, max_seq = serve_shape(arch, model.cfg)
    toks = torch.randint(1, model.cfg.vocab_size, (B, prompt),
                         device="cuda")
    inputs = serve_inputs(model.cfg, toks)

    def prefill():
        with torch.inference_mode():
            model.prefill(inputs, max_seq)

    prefill()
    fname = "profile_serve_prefill.txt" if arch == "zamba2-7b" else \
        f"profile_serve_prefill_{arch}.txt"
    wall_ms, busy_ms, ours, _ = profile_call(
        prefill, fname, f"one {arch} prefill ({B} x {prompt} tokens)")
    kernel_share(arch, "prefill", which, ours, busy_ms, wall_ms)
    print(f" (serve's unprofiled prefills: "
          f"{', '.join(f'{x:.1f}' for x in prefill_ms)} ms)", flush=True)


def profile_decode(arch, model, B=SERVE_BATCH, which=None):
    """One decode step under torch.profiler, after a prefill, with kernel
    ``which``'s share of it if given (table in
    chiprun_out/profile_serve_decode.txt for Zamba2-7B,
    profile_serve_decode_<arch>.txt for the others)."""
    prompt, start, max_seq = serve_shape(arch, model.cfg)
    toks = torch.randint(1, model.cfg.vocab_size, (B, prompt),
                         device="cuda")
    with torch.inference_mode():
        _, cache = model.prefill(serve_inputs(model.cfg, toks), max_seq)
        tok, pos = toks[:, -1], start + prompt
        model.decode_step(cache, tok, pos)    # warm

        def step():
            with torch.inference_mode():
                model.decode_step(cache, tok, pos + 1)

        fname = "profile_serve_decode.txt" if arch == "zamba2-7b" else \
            f"profile_serve_decode_{arch}.txt"
        wall_ms, busy_ms, ours, _ = profile_call(
            step, fname, f"one {arch} decode step (batch {B}, cache "
            f"{max_seq})")
    if which:
        kernel_share(arch, "decode step", which, ours, busy_ms, wall_ms)
        print(flush=True)


def moe_layers(model):
    from repro_torch.models.moe import MoE
    return [m for m in model.modules() if isinstance(m, MoE)]


@contextmanager
def routed(model):
    """What every MoE layer the model runs inside the block routes: a
    forward pre-hook on each layer routes the layer's input again with
    ``moe._route`` and ``moe._positions`` (grouped as ``apply_moe`` groups
    it, with its ``no_drop``), which the layer's own output does not depend
    on. Yields a dict that holds, after the block, ``dropped`` and
    ``assignments`` (the routed assignments past their expert's capacity,
    and all of them) and ``last``: for each layer call in order, the
    sorted top-k experts of the input's last position, a row each."""
    from repro_torch.models import moe as M
    kept, last = [], []

    def hook(mod, args, kwargs):
        x, m = args[0], mod.cfg.moe
        B, S, D = x.shape
        gs = M._group_size(m, B, S)
        _, _, topi = M._route(m, x.reshape(B * S // gs, gs, D), mod.router)
        kept.append(M._positions(m, topi, gs, kwargs.get("no_drop",
                                                          False))[1])
        last.append(topi.reshape(B, S, -1)[:, -1].sort(-1).values)

    handles = [mod.register_forward_pre_hook(hook, with_kwargs=True)
               for mod in moe_layers(model)]
    out = {}
    try:
        yield out
    finally:
        for h in handles:
            h.remove()
    out["dropped"] = sum(int((~k).sum()) for k in kept)
    out["assignments"] = sum(k.numel() for k in kept)
    out["last"] = last


def checked_consistency(arch, cfg, model, tol, unless_flipped=False):
    """``decode_consistency`` under ``routed``: the routed assignments its
    two prefills and decode step dropped (there must be none), and in how
    many (row, MoE layer) pairs the decoded token's top-k experts differ
    from those of the full prefill's last position. With
    ``unless_flipped``, ``tol`` is held only where no such pair differs
    (a flipped route computes another function, which no rounding limit
    bounds)."""
    n = len(moe_layers(model))
    with routed(model) as seen:
        gap = decode_consistency(arch, cfg, model,
                                 tol=None if unless_flipped else tol)
    dec, full = seen["last"][n:2 * n], seen["last"][2 * n:]
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(dec, full))
    held = "" if not unless_flipped else (
        f"; the gap held within {tol:g}: no route flipped" if not flips
        else "; the gap not held: routes flipped")
    print(f"[serve] {arch} ({cfg.dtype}): at capacity factor "
          f"{cfg.moe.capacity_factor:g} the check's two prefills and decode "
          f"step dropped {seen['dropped']} of {seen['assignments']} routed "
          f"assignments; the decoded token's top-{cfg.moe.top_k} experts "
          f"differ from the full prefill's last position's in {flips} of "
          f"{dec[0].shape[0] * n} (row, MoE layer) pairs{held}", flush=True)
    if seen["dropped"]:
        raise AssertionError(f"{arch}: the decode check's prefill dropped "
                             f"{seen['dropped']} assignments")
    if unless_flipped and not flips and not gap <= tol:
        raise AssertionError(f"{arch}: decode vs prefill gap {gap:.3e} with "
                             f"no route flipped")


@contextmanager
def moe_options(model, **fields):
    """The model's MoE layers with other ``MoEConfig`` fields (a capacity
    factor, a dispatch) inside the block (every module that holds the
    model's config gets a copy with them)."""
    import dataclasses
    old = model.cfg
    new = old.replace(moe=dataclasses.replace(old.moe, **fields))
    mods = [m for m in model.modules() if getattr(m, "cfg", None) is old]
    for m in mods:
        m.cfg = new
    try:
        yield
    finally:
        for m in mods:
            m.cfg = old


def moe_float32_checks(arch, cfg):
    """An MoE model at full published width in float32 (built from seed 0
    once the bf16 model is freed; ~61 GiB of weights for DeepSeekMoE-16B
    at full depth, ~20 GiB for DeepSeek-V2 at FLOAT32_LAYERS' depth): the
    decode-vs-prefill check at ``no_drop_capacity``, held within
    FLOAT32_CONSISTENCY_TOL (the decode path against the prefill without
    bf16's rounding; for MLA the absorbed decode against the expanded
    prefill), with no assignment dropped; then ``dispatch_check``."""
    import dataclasses

    from repro_torch.models import build_model
    published = cfg.moe.capacity_factor
    cfg = cfg.replace(dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=no_drop_capacity(cfg.moe)))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, "cuda", seed=0)
    print(f"[serve] {arch} (float32): {cfg.num_layers} layers", flush=True)
    checked_consistency(arch, cfg, model, tol=FLOAT32_CONSISTENCY_TOL)
    dispatch_check(arch, model, published)
    weights = sum(p.numel() for p in model.parameters()) * 4 / 2**30
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve] {arch} (float32): weights {weights:.2f} GiB, peak "
          f"device memory {peak:.2f} GiB", flush=True)
    del model
    torch.cuda.empty_cache()


def dispatch_check(arch, model, factor, B=2):
    """One prefill of B x SERVE_PROMPT seeded tokens through the MoE
    layers' ``"scatter"`` dispatch against their ``"einsum"`` dispatch
    at capacity factor ``factor`` (the published one, where tokens are
    dropped), held within DISPATCH_TOL of max|logit|, with the routed
    assignments dropped counted."""
    g = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, model.cfg.vocab_size, (B, SERVE_PROMPT),
                         generator=g, device="cuda")
    out = {}
    for dispatch in ("einsum", "scatter"):
        with moe_options(model, capacity_factor=factor, dispatch=dispatch), \
                routed(model) as seen, torch.inference_mode():
            out[dispatch] = model.prefill({"tokens": toks},
                                          SERVE_MAX_SEQ)[0]
    e, sc = out["einsum"], out["scatter"]
    if not (torch.isfinite(e).all() and torch.isfinite(sc).all()):
        raise AssertionError(f"{arch}: non-finite logits")
    gap = (sc - e).abs().max().item() / e.abs().max().item()
    print(f"[serve] {arch} ({model.cfg.dtype}): a {B} x {SERVE_PROMPT}-token "
          f"prefill through the scatter dispatch vs the einsum dispatch at "
          f"capacity factor {factor:g} ({seen['dropped']} of "
          f"{seen['assignments']} routed assignments dropped): max|logit "
          f"gap| / max|logit| = {gap:.3e} (limit {DISPATCH_TOL:g})",
          flush=True)
    if not gap <= DISPATCH_TOL:
        raise AssertionError(f"{arch}: scatter vs einsum gap {gap:.3e}")


def moe_serve_checks(arch, cfg, model, res):
    """After ``serve``: each round's prefill again on its prompts (serve's
    ``RandomState(0)`` stream) with the routed assignments it dropped at
    the config's capacity factor counted; round 0's prefill once more,
    its logits and cache bit for bit the first's (the dispatch adds in no
    order that varies); decode against prefill at ``no_drop_capacity``,
    where the prefills must drop nothing, held in bf16 only where no
    route flipped (a routing boundary crossed in bf16 moves the logits by
    more than bf16's limit; ``moe_float32_checks`` holds the check in
    float32);
    a profiled prefill and decode step with #4's share."""
    import numpy as np
    rng = np.random.RandomState(0)
    m = cfg.moe
    for r, bsz in enumerate(res.batches):
        toks = torch.tensor(rng.randint(1, cfg.vocab_size,
                                        size=(bsz, SERVE_PROMPT)),
                            device="cuda")
        with routed(model) as drops, torch.inference_mode():
            logits, cache = model.prefill({"tokens": toks}, SERVE_MAX_SEQ)
        torch.cuda.synchronize()
        gs = min(m.group_size, bsz * SERVE_PROMPT)
        print(f"[serve] {arch}: round {r} prefill ({bsz} x {SERVE_PROMPT} "
              f"tokens, groups of {gs}, capacity factor {m.capacity_factor}"
              f", {m.num_experts} experts, top {m.top_k}): "
              f"{drops['dropped']} of {drops['assignments']} routed "
              f"assignments dropped "
              f"({100 * drops['dropped'] / drops['assignments']:.3f}%) over "
              f"its {len(moe_layers(model))} MoE layers", flush=True)
        if r:
            continue
        with torch.inference_mode():
            again, cache2 = model.prefill({"tokens": toks}, SERVE_MAX_SEQ)
        leaves = [(k, n) for k in cache for n in cache[k]]
        same = torch.equal(logits, again) and all(
            torch.equal(cache[k][n], cache2[k][n]) for k, n in leaves)
        print(f"[serve] {arch}: round 0's prefill run twice: logits and "
              f"{len(leaves)} cache leaves bit for bit equal: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{arch}: two prefills of the same tokens "
                                 f"differ")
        del cache, cache2, logits, again
    torch.cuda.reset_peak_memory_stats()
    with moe_options(model, capacity_factor=no_drop_capacity(m)):
        checked_consistency(arch, model.cfg, model, tol=CONSISTENCY_TOL,
                            unless_flipped=True)
    print(f"[serve] {arch}: peak device memory of the no-drop check "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_prefill(arch, model, res.prefill_ms, which="#4")
    profile_decode(arch, model, which="#4")


# ----------------------------------------------- phase 6b: the trainer

# the reference trainer's defaults (src/repro/launch/train.py): batch 8,
# sequence 256, lr 3e-3, warmup 20
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 256, 3e-3
TRAIN_STEPS_PER_HOUR = 5              # the carbon gate's base budget here
# Zamba2-7B at its published widths, cut to its first 12 of 81 Mamba2
# layers (two groups of 6 around the shared block): weights, gradients
# and AdamW's float32 moments at full depth take ~89 GB
ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_STEPS = 12, 2
# RWKV6-7B at its published widths, cut to 8 of 32 layers (~2.3 B
# parameters, ~29 GB with AdamW's moments; ~95 GB at full depth)
RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = 8, 2
# DeepSeekMoE-16B at its published widths, cut to 4 of 28 layers (its dense
# first layer and 3 MoE layers; ~2.3 B parameters, about RWKV6's at 8)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 2
# DeepSeek-V2-236B at its published widths, cut to 1 of 60 layers: its
# dense first layer with its MLA mixer (1.39 B parameters, ~36 GB with
# AdamW's old and new float32 moments at ~26 bytes a parameter); one MoE
# layer more (5.36 B, ~130 GB) does not fit the card
V2_TRAIN_LAYERS, V2_TRAIN_STEPS = 1, 2
# The dense models at their published widths, depths set by AdamW's
# memory (~29 bytes a parameter at a step's peak: the bf16 weights and
# gradients, the float32 moments old and new): Yi-6B at 8 of 32 layers
# (8 x 173 M + 2 x 64,000 x 4,096 of embedding and untied head: 1.91 B,
# ~52 GiB reckoned), Gemma2-9B at 4 of 42 (an even number, so that its
# local and global layers pair: 4 x 198 M + its tied 256,000 x 3,584
# embedding: 1.71 B, ~46 GiB, and 8 x 255 x 256,000 float32 logits, ~2 GB,
# with their gradient), DeepSeek-67B at 1 of 95 (0.69 B + 1.68 B of
# embedding and head: 2.37 B, ~64 GiB); their peaks measured 41.3, 49.9
# and 62.5 GiB on an H100 80GB HBM3 at 700 W; InternVL2-2B (~1.9 B
# parameters; 256 vision positions before each sequence) and Whisper-base
# (~71 M; 1,500 frames) at full depth (None)
FAMILY_TRAIN_LAYERS = {"internvl2-2b": None, "whisper-base": None,
                       "yi-6b": 8, "gemma2-9b": 4, "deepseek-67b": 1}
FAMILY_TRAIN_STEPS = 2
GRAD_TOL = 2e-2                       # Function vs plain gradients, x max
RESUME_TOL = 1e-5                     # tests/test_checkpoint_data.py:69
BF16_PEAK = 989e12                    # H100 SXM dense bf16 FLOP/s


def train_counts(cfg, steps):
    """Launches of (#4, #5) in ``steps`` train steps: the forward of every
    attention layer (Zamba2's shared block once a group; a dense, MoE or
    VLM model's every layer; an encoder-decoder's encoder layers and its
    decoder layers' self and cross attention) and every Mamba2 or RWKV6
    layer; the backward recomputes the plain versions and launches
    none."""
    if cfg.family == "encdec":
        return steps * (cfg.encoder_layers + 2 * cfg.num_layers), 0
    if cfg.family == "hybrid":
        return steps * (cfg.num_layers // cfg.attn_every), \
            steps * cfg.num_layers
    if cfg.family == "ssm":
        return 0, steps * cfg.num_layers
    return steps * cfg.num_layers, 0


def step_parts(label, model, cfg, fname):
    """One train step's parts on the host clock (each ended by a
    synchronize; median of 3 after a warm-up): the forward with the loss,
    the backward, the AdamW update (and its copy into the parameters);
    then one whole step under torch.profiler (table to chiprun_out/)."""
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.training import init_train_state, make_train_step
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=20, decay_steps=100)
    toks = batch_at(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 0)
    batch = {"tokens": torch.tensor(toks["tokens"], dtype=torch.int64,
                                    device="cuda")}
    params = dict(model.named_parameters())
    state = init_train_state(model, opt)
    parts = {"forward + loss": [], "backward": [], "AdamW update": []}
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        new, state["opt"], _ = adamw_update(params, grads, state["opt"], opt)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del new, grads, loss
        for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3))):
            parts[k].append(1e3 * (b - a))
    med = {k: statistics.median(v[1:]) for k, v in parts.items()}
    print(f"[train] {label}: a step's parts (host clock, synchronised, "
          f"median of 3): " + ", ".join(f"{k} {v:.1f} ms"
                                        for k, v in med.items()), flush=True)
    step = make_train_step(model, opt)
    profile_call(lambda: step(state, batch), fname, f"{label} train step")
    return med


def run_train(label, cfg, steps, profile=None, **kw):
    """``launch.train.train`` of a model built from ``cfg`` (seed 0) on the
    card with the counters at 0 just before it; exact launches of #4 and
    #5 (and their routes), a finite loss every step (and for an MoE model
    a finite aux loss, read from the loss's metrics); with ``profile``, a
    step's parts and a profiled step after it (``step_parts``). Returns
    the result and the launches of #4 and #5 counted in the run."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    # a wrapped ``model.loss`` (below) refers back to its model, which so
    # outlives the run that built it: collect it, so that this run's peak
    # memory holds none of an earlier model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"[train] {label}: {n / 1e9:.3f} B parameters ({cfg.dtype}, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}), built on the "
          f"card from seed 0 in {time.perf_counter() - t0:.2f} s", flush=True)
    if cfg.family == "vlm":
        # the stub's zero vision embeddings keep every vision position's
        # residual stream at zero, where rms_norm's gradient is 1 /
        # sqrt(eps) at each norm: past ~17 layers the gradients overflow
        # to NaN, in both packages (ROADMAP.md §3); a frontend's output is
        # not zero, so the run feeds seeded embeddings at the token
        # embeddings' scale in their place
        g = torch.Generator(device="cuda").manual_seed(0)
        ve = (cfg.d_model ** -0.5 * torch.randn(
            (TRAIN_BATCH, cfg.vision_tokens, cfg.d_model), generator=g,
            device="cuda")).to(model.dtype)
        vlm_loss = model.loss
        model.loss = lambda batch: vlm_loss({**batch, "vision_embeds": ve})
        print(f"[train] {label}: vision embeddings seeded (normal x "
              f"d_model^-0.5) in place of the stub's zeros", flush=True)
    auxes = []
    if cfg.moe:
        loss_of = model.loss

        def loss_and_aux(batch):
            loss, metrics = loss_of(batch)
            auxes.append(metrics["aux_loss"].detach())
            return loss, metrics

        model.loss = loss_and_aux
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = train(model=model, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                lr=TRAIN_LR, device="cuda", log_every=5, **kw)
    counts = read_counts()
    routes = dict(fa_kernel.flash_attention_cuda.routes)
    gla_routes = dict(gla_kernel.gla_cuda.routes)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = train_counts(cfg, steps)
    step_ms = statistics.median(res.step_ms[1:] or res.step_ms)
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)         # positions predicted
    flops = 6 * n * tokens
    print(f"[train] {label}: {len(res.step_losses)} steps, loss "
          f"{[round(x, 4) for x in res.step_losses]}; step ms first "
          f"{res.step_ms[0]:.1f}, median of the rest {step_ms:.2f} "
          f"({1e3 / step_ms:.2f} steps/s, {1e3 * tokens / step_ms:.0f} "
          f"tokens/s of the T below); 6 N T = {flops / 1e12:.2f} TFLOP a step (N = {n}, "
          f"T = {tokens}), {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s, "
          f"{100 * flops / (step_ms / 1e3) / BF16_PEAK:.1f}% of the bf16 "
          f"peak; peak device memory {peak:.2f} GiB; launches of #1 to #5 "
          f"{counts} (expected [0, 0, 0, {want[0]}, {want[1]}]); #4 by "
          f"route {routes}, #5 by route {gla_routes}", flush=True)
    if not all(map(math.isfinite, res.step_losses)) \
            or len(res.step_losses) != steps:
        raise AssertionError(f"[train] {label}: a loss is not finite")
    if cfg.moe:
        aux = [float(a) for a in auxes]
        print(f"[train] {label}: aux loss each step {aux} (router_aux_weight "
              f"{cfg.moe.router_aux_weight}, summed over "
              f"{cfg.num_layers - cfg.moe.first_dense_layers} MoE layers)",
              flush=True)
        if len(aux) != steps or not all(map(math.isfinite, aux)):
            raise AssertionError(f"[train] {label}: aux loss {aux}")
    if counts != [0, 0, 0, *want]:
        raise AssertionError(f"[train] {label}: launches {counts}, expected "
                             f"{[0, 0, 0, *want]}")
    # bf16 forwards: #4 on its tensor-core prefill route, #5 on gla_ssd
    # (Mamba2) or gla_vec (RWKV6)
    want_gla = dict.fromkeys(gla_kernel.SOURCES, 0)
    want_gla[gla_route_of(cfg)] = want[1]
    if routes != {"flash_prefill": want[0], "flash_decode": 0,
                  "flash_attention": 0} or gla_routes != want_gla:
        raise AssertionError(f"[train] {label}: routes {routes} / "
                             f"{gla_routes}")
    if profile:
        step_parts(label, model, cfg, profile)
    del model
    torch.cuda.empty_cache()
    return res, counts[3:5], gla_routes


def function_grads(label, fn, plain, inputs, leaves, reps=10, library=None):
    """The gradients of ``sum(w * out[0])`` to ``leaves`` through ``fn``
    (the autograd Function with the kernel forward) and through ``plain``
    (the plain route under autograd), each from fresh ``inputs()``; the
    forward outputs within bf16's 2e-2 of max, each gradient within
    GRAD_TOL of its largest |value|; and the CUDA-event ms of a forward +
    backward each way, timed in turns (``cuda_ms_turns``), with
    ``library=(name, make)`` a library's too (``make(w)``: its forward +
    backward of ``sum(w * out)``). Returns the ms by way: ``function``,
    ``plain`` and ``library``."""
    outs, ways = {}, {}
    for name, f in (("function", fn), ("plain", plain)):
        out = f(*inputs())
        w = torch.randn(out[0].shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
        grads = torch.autograd.grad((out[0].float() * w).sum(), leaves)
        outs[name] = (out[0].detach(), grads)

        def fwd_bwd(f=f, w=w):
            o = f(*inputs())[0]
            torch.autograd.grad((o.float() * w).sum(), leaves)
        ways[name] = fwd_bwd
    if library is not None:
        ways["library"] = library[1](w)
    ms = cuda_ms_turns(ways, reps)
    (o1, g1), (o2, g2) = outs["function"], outs["plain"]
    fgap = ((o1.float() - o2.float()).abs().max()
            / o2.float().abs().max()).item()
    gaps = [((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp(min=1e-30)).item()
            for a, b in zip(g1, g2)]
    exact = all(torch.equal(a, b) for a, b in zip(g1, g2))
    lib = "" if library is None else (
        f", {ms['library']:.3f} ms by the library ({library[0]}), Function "
        f"/ library {ms['function'] / ms['library']:.2f}x")
    print(f"[train] {label}: forward (kernel) vs plain {fgap:.3e} (limit "
          f"2e-2 x max); gradients vs the plain route's (a wiring check: "
          f"both backwards are the plain version's autograd on the same "
          f"saved inputs), largest gap relative to the largest |value| per "
          f"input {[f'{x:.3e}' for x in gaps]} (limit {GRAD_TOL}), bit for "
          f"bit: {exact}; forward + backward {ms['function']:.3f} ms through "
          f"the Function, {ms['plain']:.3f} ms plain{lib} (CUDA events, "
          f"median of {reps} in turns)", flush=True)
    if fgap > 2e-2 or max(gaps) > GRAD_TOL:
        raise AssertionError(f"[train] {label}: forward {fgap:.3e} or "
                             f"gradients {gaps} beyond their limits")
    return ms


def cuda_ms_turns(fns, reps, warmup=3):
    """Median CUDA-event ms of each of ``fns`` (name -> callable), timed in
    turns: every repetition runs each once, so a drift of the card's clock
    or of the host's load falls on all of them alike."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def flash_function_case(label, card, q, k, v, kw, reps=30):
    """#4's autograd Function (``ops.FlashAttention``, the kernel forward)
    at leaves q, k, v and mask options ``kw`` against the plain route
    (``function_grads``), its forward + backward timed in turns with one
    library call's (``library_call``: SDPA, or compiled flex_attention
    under a softcap); and the least time a forward + backward could take:
    the larger of 3.5 x the forward's products (FlashAttention-2's count:
    the backward takes 2.5 x the forward's) over the peak rate of the
    type, and 3 x the forward's bytes over the memory rate (the backward
    reads q, k, v, o and dO and writes dq, dk and dv once). Returns its
    record."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    B, Sq, N, H = q.shape
    Sk, K = k.shape[1], k.shape[2]
    pairs = {x: kw[x] for x in ("causal", "window", "q_offset", "length")}
    flops = fa_kernel.attention_flops(B, Sq, Sk, N, H, **pairs)
    nbytes = fa_kernel.attention_bytes(B, Sq, Sk, N, K, H, q.element_size(),
                                       **pairs)
    bound_ms, by, _, _ = card.bound(3.5 * flops, 3 * nbytes, q.dtype)
    name, lib = library_call(q, k, v, kw)

    def make(w):
        wt = w.transpose(1, 2)

        def fwd_bwd():
            torch.autograd.grad((lib().float() * wt).sum(), (q, k, v))
        return fwd_bwd
    with stack_limit_kept():
        ms = function_grads(
            label, lambda *x: (fa_ops.FlashAttention.apply(
                *x, fa_kernel.flash_attention_cuda, kw),),
            lambda *x: (fa_ref.attention_chunked(*x, **kw),),
            lambda: (q, k, v), (q, k, v), reps=reps, library=(name, make))
    print(f"[train] {label}: bound of a forward + backward {bound_ms:.4f} ms "
          f"by {by} (forward products x 3.5, bytes x 3), the Function at "
          f"{100 * bound_ms / ms['function']:.1f}% of it", flush=True)
    return {"ms": ms["function"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "library": name,
            "bound_ms": bound_ms, "bound_by": by}


def phase_function_grads(card):
    """Kernels #4 and #5 wrapped for autograd (``ops.FlashAttention``,
    ``ops.GLAScan``) against the plain route on the card, bf16: #4 at
    Whisper-base's cross-attention (``cross_grads``), a full-width
    Qwen3-0.6B attention layer of a train step (8 x 256 positions, 16
    query heads on 8 KV heads of 128, causal) and Gemma2-9B's local layer
    (``gemma2_grads``); #5 at Zamba2-7B's Mamba2 training shapes (the
    heads and state of ``gla_cases``: 112 heads, state 64, head 64, chunk
    256; B and C shared by the heads) and RWKV6-7B's time mix. Returns
    #4's records by label (``flash_function_case``)."""
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    from repro_torch.kernels.linear_scan import ops as gla_ops
    from repro_torch.kernels.linear_scan import ref as gla_ref
    g = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    records = dict([cross_grads(g, card)])

    def leaf(*shape, dt=bf, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(
            dt).requires_grad_()

    B, S = TRAIN_BATCH, TRAIN_SEQ
    q, k, v = leaf(B, S, 16, 128), leaf(B, S, 8, 128), leaf(B, S, 8, 128)
    label = "#4 FlashAttention, Qwen3-0.6B layer (8 x 256, 16 / 8 heads of 128)"
    records[label] = flash_function_case(label, card, q, k, v, FUNCTION_KW)
    records.update([gemma2_grads(g, card)])
    H, K, V = 112, 64, 64
    c, b, xv = leaf(B, S, 1, K), leaf(B, S, 1, K), leaf(B, S, H, V)
    raw = leaf(B, S, H, dt=torch.float32)
    opts = dict(strict=False, chunk=256)

    def gla_inputs_():
        return (c.expand(B, S, H, K), b.expand(B, S, H, K), xv,
                -0.7 * raw.abs())

    function_grads(
        "#5 GLAScan, Zamba2-7B Mamba2 layer (8 x 256, 112 heads, state 64)",
        lambda *x: gla_ops.GLAScan.apply(*x, None, None, gla_kernel.gla_cuda,
                                         opts),
        lambda *x: gla_ref.gla_chunked(*x, **opts),
        gla_inputs_, (c, b, xv, raw))
    # RWKV6's training shape: the 255 positions a 256-token sequence feeds
    # the model, 64 heads of 64, a float32 per-channel decay, the bonus u
    # (a float32 parameter) and the strict mode, chunk 64
    S, H, K = TRAIN_SEQ - 1, 64, 64
    r, kk, vv = (leaf(B, S, H, K) for _ in range(3))
    w_raw, u = leaf(B, S, H, K, dt=torch.float32), \
        leaf(H, K, dt=torch.float32, scale=0.1)
    ropts = dict(strict=True, chunk=64)

    def rwkv_inputs():
        return r, kk, vv, -torch.exp(-3.0 + w_raw)

    function_grads(
        "#5 GLAScan, RWKV6-7B time mix (8 x 255, 64 heads of 64, bonus, "
        "strict)",
        lambda *x: gla_ops.GLAScan.apply(*x, u, None, gla_kernel.gla_cuda,
                                         ropts),
        lambda *x: gla_ref.gla_chunked(*x, bonus=u, **ropts),
        rwkv_inputs, (r, kk, vv, w_raw, u))
    return records


# #4's Function's mask options, each case replacing what it sets
FUNCTION_KW = dict(causal=True, window=None, softcap=None, q_offset=0,
                   length=None, scale=None)


def gemma2_grads(g, card):
    """#4's autograd Function at Gemma2-9B's widths (16 query heads on 8 KV
    heads of 256) with its local layer's window of 4,096 and attention
    softcap of 50, over one sequence of 4,608 positions (the served
    prompt: the window binds on its last 512 queries), against the plain
    route, bf16. q is scaled by 8, so that the scores (std ~8) reach the
    softcap's bend. Returns (label, record)."""
    S = SERVE_PROMPTS["gemma2-9b"]

    def leaf(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(
            torch.bfloat16).requires_grad_()

    q, k, v = leaf(1, S, 16, 256, scale=8.0), leaf(1, S, 8, 256), \
        leaf(1, S, 8, 256)
    label = (f"#4 FlashAttention, Gemma2-9B local layer (1 x {S}, 16 / 8 "
             f"heads of 256, window 4096, softcap 50)")
    return label, flash_function_case(label, card, q, k, v, dict(
        FUNCTION_KW, window=4096, softcap=50.0), reps=20)


def cross_grads(g, card):
    """#4's autograd Function at Whisper-base's cross-attention in a train
    step (8 x 255 decoder positions on 1,500 frames, 8 heads of 64,
    non-causal: the gradients reach the encoder through k and v) against
    the plain route, bf16. Returns (label, record)."""
    def leaf(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16).requires_grad_()

    B, S = TRAIN_BATCH, TRAIN_SEQ - 1
    q, k, v = leaf(B, S, 8, 64), leaf(B, FRAMES, 8, 64), \
        leaf(B, FRAMES, 8, 64)
    label = (f"#4 FlashAttention, Whisper-base cross-attention ({B} x {S} on "
             f"{FRAMES} frames, 8 heads of 64, non-causal)")
    return label, flash_function_case(label, card, q, k, v, dict(
        FUNCTION_KW, causal=False))


def kill_and_resume():
    """``python -m repro_torch.launch.train --smoke`` on the card in
    subprocesses: killed at step 17 (after the step-10 checkpoint), resumed
    to 30, against an uninterrupted run to 30 beside them; every leaf of
    the step-30
    checkpoints bit for bit, or within RESUME_TOL (the reference test's
    limit, where the card's atomic adds in the embedding's backward may
    reorder a sum)."""
    import os
    import shutil

    import numpy as np
    out = ROOT / "build" / "train_ckpt"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-0.6b", "--smoke", "--steps", "30", "--batch", "2",
            "--seq", "64", "--ckpt-every", "10", "--log-every", "10",
            "--device", "cuda"]

    def start(extra):
        return (extra, time.perf_counter(), subprocess.Popen(
            base + extra, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))

    def finish(job, rc):
        extra, t0, proc = job
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != rc:
            raise AssertionError(f"[train] {' '.join(extra)}: exit "
                                 f"{proc.returncode}, expected {rc}: "
                                 f"{stderr[-2000:]}")
        return stdout, time.perf_counter() - t0

    # the uninterrupted run beside the killed one and its relaunch
    whole = start(["--ckpt-dir", str(out / "b")])
    try:
        _, ta = finish(start(["--ckpt-dir", str(out / "a"),
                              "--kill-at-step", "17"]), 42)
        resumed, tb = finish(start(["--ckpt-dir", str(out / "a")]), 0)
    finally:
        _, tc = finish(whole, 0)
    if "resumed from step 10" not in resumed:
        raise AssertionError("[train] the relaunch did not resume from 10")
    da, db = (out / x / "step_00000030" / "arrays" for x in "ab")
    names = sorted(p.name for p in db.iterdir())
    gap, exact = 0.0, True
    for name in names:
        a, b = np.load(da / name), np.load(db / name)
        exact &= a.tobytes() == b.tobytes()
        if a.dtype == np.uint16:             # bf16 bits
            a, b = (torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
                    .float().numpy() for x in (a, b))
        gap = max(gap, float(np.abs(a.astype(np.float64)
                                    - b.astype(np.float64)).max()))
    shutil.rmtree(out, ignore_errors=True)
    print(f"[train] kill at step 17 and resume to 30 on the card (smoke "
          f"config, subprocesses of {ta:.1f} / {tb:.1f} / {tc:.1f} s): "
          f"{len(names)} leaves of the step-30 checkpoint against an "
          f"uninterrupted run: bit for bit {exact}, largest |gap| "
          f"{gap:.3e} (limit {RESUME_TOL})", flush=True)
    if gap > RESUME_TOL:
        raise AssertionError(f"[train] resumed run off by {gap:.3e}")


def train_families():
    """The models of FAMILY_TRAIN_LAYERS at their published widths and
    depths there, for FAMILY_TRAIN_STEPS steps each (``run_train``:
    Whisper's batches carry the stub's zero frames, InternVL2's seeded
    vision embeddings in place of the stub's zeros). Returns each one's
    launches of #4 and #5."""
    from repro_torch.configs import get_arch
    launched = {}
    for arch, layers in FAMILY_TRAIN_LAYERS.items():
        cfg = get_arch(arch).config
        layers = layers or cfg.num_layers
        label = f"{arch} ({layers} of {cfg.num_layers} layers" + (
            f", {cfg.encoder_layers} encoder layers"
            if cfg.encoder_layers else "") + ")"
        launched[arch] = run_train(
            label, cfg.replace(num_layers=layers, remat="none"),
            FAMILY_TRAIN_STEPS)[1]
    return launched


def phase_train(card):
    """The trainer on the card: Qwen3-0.6B at full published width in bf16
    for TRAIN_STEPS steps with the carbon gate on (each hour's budget
    printed), loss finite and falling; the autograd Functions' gradients
    against the plain route; Zamba2-7B and RWKV6-7B at their published
    widths and ZAMBA_TRAIN_LAYERS / RWKV_TRAIN_LAYERS layers; the
    kill-and-resume replay; DeepSeekMoE-16B and DeepSeek-V2-236B at their
    published widths and MOE_TRAIN_LAYERS / V2_TRAIN_LAYERS layers;
    InternVL2-2B and Whisper-base at full width and depth, Yi-6B,
    Gemma2-9B and DeepSeek-67B at FAMILY_TRAIN_LAYERS' depths. Returns
    the launches of #4 and #5 on the training runs, #5's calls by model
    and route, #4's launches by model, and #4's Function's records by
    label (``phase_function_grads``)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("qwen3-0.6b").config.replace(remat="none")
    res, launched, _ = run_train("qwen3-0.6b", cfg, TRAIN_STEPS,
                              profile="profile_train_step.txt",
                              carbon_aware=True,
                              steps_per_hour=TRAIN_STEPS_PER_HOUR)
    first, last3 = res.step_losses[0], statistics.mean(res.step_losses[-3:])
    print(f"[train] qwen3-0.6b: carbon-aware budgets an hour "
          f"{res.budgets} (base {TRAIN_STEPS_PER_HOUR}); loss falls: the "
          f"mean of the last 3 steps {last3:.4f} < the first step's "
          f"{first:.4f}: {last3 < first}", flush=True)
    if not last3 < first:
        raise AssertionError("[train] qwen3-0.6b: the loss did not fall")
    totals = list(launched)
    autograd = phase_function_grads(card)
    zcfg = get_arch("zamba2-7b").config.replace(
        num_layers=ZAMBA_TRAIN_LAYERS, remat="none")
    _, zlaunched, zroutes = run_train(
        f"zamba2-7b ({ZAMBA_TRAIN_LAYERS} of 81 layers)", zcfg,
        ZAMBA_TRAIN_STEPS)
    rcfg = get_arch("rwkv6-7b").config.replace(
        num_layers=RWKV_TRAIN_LAYERS, remat="none")
    _, rlaunched, rroutes = run_train(
        f"rwkv6-7b ({RWKV_TRAIN_LAYERS} of 32 layers)", rcfg,
        RWKV_TRAIN_STEPS, profile="profile_train_step_rwkv6-7b.txt")
    mcfg = get_arch("deepseek-moe-16b").config.replace(
        num_layers=MOE_TRAIN_LAYERS, remat="none")
    _, mlaunched, _ = run_train(
        f"deepseek-moe-16b ({MOE_TRAIN_LAYERS} of 28 layers)", mcfg,
        MOE_TRAIN_STEPS)
    vcfg = get_arch("deepseek-v2-236b").config.replace(
        num_layers=V2_TRAIN_LAYERS, remat="none")
    _, vlaunched, _ = run_train(
        f"deepseek-v2-236b ({V2_TRAIN_LAYERS} of 60 layers)", vcfg,
        V2_TRAIN_STEPS)
    families = train_families()
    totals = [sum(x) for x in zip(totals, zlaunched, rlaunched, mlaunched,
                                  vlaunched, *families.values())]
    kill_and_resume()
    fa_by_model = {"qwen3-0.6b": launched[0], "zamba2-7b": zlaunched[0],
                   "deepseek-moe-16b": mlaunched[0],
                   "deepseek-v2-236b": vlaunched[0],
                   **{a: n[0] for a, n in families.items()}}
    return (totals, {"zamba2-7b": zroutes, "rwkv6-7b": rroutes}, fa_by_model,
            autograd)


# ----------------------------------------------- phase 6c: the examples

# scenario_sweep's variants beyond its default library run at 3 days and
# 2 seeds (the default mode and the other four examples at the originals'
# defaults)
SWEEP_SHORT = ["--days", "3", "--seeds", "2"]
SWEEP_DAYS, SWEEP_SEEDS = 3, 2
EXAMPLE_TRACE = "chiprun_out/examples_trace.jsonl"
EXAMPLE_CKPT = ROOT / "build" / "examples_ckpt"
# train_carbon_aware's ~100M float32 config (12 layers, 8 query heads on 4
# KV heads of 64) at its batch 4 x sequence 128: the trainer's attention
# call and its launches of #4 a step, on the float32 route
EX_TRAIN_STEPS, EX_TRAIN_LAYERS = 300, 12
EX_TRAIN_CASE = ("train_carbon_aware prefill float32 (GQA)", 4, 128, 128, 8,
                 4, 64, torch.float32, dict(causal=True))
# serve_shaped's attention calls: the Qwen3-0.6B smoke model in bfloat16
# (4 query heads on 2 KV heads of 32) at batch 4, its 24-token prompts and
# a mid-generation decode step in its 48-slot cache (24 + 16 + 8); that
# step in float32 too, where one key too many or too few shows
# (``flash_cases``)
EX_SERVE_POS = 24 + 16 // 2
EX_SERVE_DEC = dict(causal=True, q_offset=EX_SERVE_POS,
                    length=EX_SERVE_POS + 1)
EX_SERVE_CASES = [
    ("serve_shaped prefill (GQA)", 4, 24, 24, 4, 2, 32, torch.bfloat16,
     dict(causal=True)),
    ("serve_shaped decode (GQA)", 4, 1, 48, 4, 2, 32, torch.bfloat16,
     EX_SERVE_DEC),
    ("serve_shaped decode float32 (GQA)", 4, 1, 48, 4, 2, 32, torch.float32,
     EX_SERVE_DEC),
]
FIG12_MEAN_RTOL = 1e-3                # card vs CPU, treated / control means


def example_main(name):
    import importlib
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"examples_torch.{name}").main


def run_example(label, name, argv, want, want_routes=None):
    """``examples_torch/<name>.py``'s ``main(argv + ["--device",
    "cuda"])`` in-process with the counters at 0 just before it; its wall
    seconds (ended by a synchronize) and exact launches of #1 to #5
    (``want``) and, where ``want_routes`` names them, of #3's
    (``"joint_step"``) or #4's (``"flash_attention"``) routes. Returns its
    output, wall seconds, launches and both kernels' routes."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    main = example_main(name)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    routes = {"joint_step": dict(pgd_kernel.joint_step_cuda.routes),
              "flash_attention": dict(fa_kernel.flash_attention_cuda.routes)}
    s_proj = pgd_kernel.s_project_cuda.launches
    print(f"[examples] {label}: {wall:.3f} s wall; launches of #1 to #5 "
          f"{counts} (expected {want}); #3 by route {routes['joint_step']}, "
          f"s_project {s_proj}; #4 by route {routes['flash_attention']}",
          flush=True)
    if counts != want or s_proj:
        raise AssertionError(f"[examples] {label}: launches {counts} "
                             f"(s_project {s_proj}), expected {want}")
    for kernel, expected in (want_routes or {}).items():
        if routes[kernel] != expected:
            raise AssertionError(f"[examples] {label}: {kernel} routes "
                                 f"{routes[kernel]}, expected {expected}")
    return out, wall, counts, routes


def all_finite(label, values):
    bad = [v for v in values if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"[examples] {label}: non-finite {bad}")


def check_sweep_rows(label, rows):
    """Every number of a sweep table finite, flex<24h% in [0, 100]."""
    for r in rows:
        all_finite(f"{label} {r['scenario']}",
                   [v for k, v in r.items() if isinstance(v, float)])
        if not 0.0 <= r.get("flex_within_24h_pct", 0.0) <= 100.0:
            raise AssertionError(f"[examples] {label} {r['scenario']}: "
                                 f"flex<24h% {r['flex_within_24h_pct']}")


def fig12_draws(n_clusters, days):
    """(treated, control) cluster-days of the numpy coin the experiment
    draws from."""
    import numpy as np
    rng = np.random.RandomState(0)
    treated = sum(int((rng.rand(n_clusters) < 0.5).sum())
                  for _ in range(days))
    return treated, n_clusters * days - treated


def fig12_card_vs_cpu(n_clusters=4, days=3):
    """``fleet_week.fig12_cluster_days`` on the card and on the CPU: the
    same treated and control counts, their means within FIG12_MEAN_RTOL
    relative (single cluster-days move with the float32 PD power fit)."""
    import importlib
    import numpy as np
    fw = importlib.import_module("examples_torch.fleet_week")
    got = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got[dev] = fw.fig12_cluster_days(n_clusters, days, device=dev)
        print(f"[examples] fig12 at {n_clusters} clusters x {days} days on "
              f"{dev}: {time.perf_counter() - t0:.2f} s", flush=True)
    (gt, gc), (ct, cc) = got["cuda"], got["cpu"]
    gaps = [abs(np.mean(a) - np.mean(b)) / abs(np.mean(b))
            for a, b in ((gt, ct), (gc, cc))]
    print(f"[examples] fig12 card vs CPU: counts {len(gt)} / {len(gc)} and "
          f"{len(ct)} / {len(cc)} (the numpy draws: "
          f"{fig12_draws(n_clusters, days)}); treated means "
          f"{np.mean(gt):.6f} / {np.mean(ct):.6f}, control "
          f"{np.mean(gc):.6f} / {np.mean(cc):.6f}: relative gaps "
          f"{gaps[0]:.3e}, {gaps[1]:.3e} (limit {FIG12_MEAN_RTOL:g})",
          flush=True)
    if (len(gt), len(gc)) != (len(ct), len(cc)) \
            or (len(gt), len(gc)) != fig12_draws(n_clusters, days) \
            or max(gaps) > FIG12_MEAN_RTOL:
        raise AssertionError("[examples] fig12 card vs CPU disagree")


def train_example_function_cost(card):
    """#4's autograd Function at train_carbon_aware's attention call in
    float32 (its forward the ``flash_attention.cu`` route, its backward
    the plain version's autograd) against the plain route: the cost of a
    forward + backward each way. Returns (label, record)."""
    _, B, S, _, N, K, H, dt, _ = EX_TRAIN_CASE
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(s, generator=g, device="cuda", dtype=dt)
               .requires_grad_() for s in ((B, S, N, H), (B, S, K, H),
                                           (B, S, K, H)))
    label = ("#4 FlashAttention, train_carbon_aware layer (4 x 128, 8 / 4 "
             "heads of 64, float32)")
    return label, flash_function_case(label, card, q, k, v, FUNCTION_KW)


def phase_examples(card):
    """The five examples of ``examples_torch/`` on the card, in-process,
    each with the counters at 0 just before it: quickstart, fleet_week,
    serve_shaped, train_carbon_aware and scenario_sweep's default mode at
    the originals' defaults; scenario_sweep's --risk, --spatial,
    --telemetry --trace and --sharded at SWEEP_SHORT. Exact launches of
    #1 to #5 (and #3's and #4's routes) each; every printed number finite,
    flex<24h% in [0, 100], the trace read back, Fig 12's counts the numpy
    draws, the loss falling (the example raises otherwise); Fig 12 on the
    card against the CPU; #4 at serve_shaped's calls (``EX_SERVE_CASES``)
    and at train_carbon_aware's float32 call against its plain version and
    SDPA, and its Function's cost beside SDPA's (#3 at the --spatial sweep's shape is
    held in ``phase_joint_s``). Returns each example's launches of #1 to
    #5 and #3's and #4's routes, by label, #4's records by case and its
    Function's record by label."""
    import shutil

    from repro_torch import sim
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.train import CarbonGate
    t_phase = time.perf_counter()
    launched, routes, walls = {}, {}, {}

    def record(label, res):
        out, walls[label], launched[label], routes[label] = res
        return out

    no_flash = dict.fromkeys(fa_kernel.SOURCES, 0)
    out = record("quickstart", run_example(
        "quickstart", "quickstart", [], [SOLVE_ROUNDS, 0, 0, 0, 0]))
    all_finite("quickstart", [v for h in out["hours"] for v in h[1:]]
               + [out["corr"], out["served"], out["arrived"]])

    week_days, week_n = 7, 16
    out = record("fleet_week", run_example(
        "fleet_week", "fleet_week", [],
        [2 * week_days * SOLVE_ROUNDS, 0, 0, 0, 0]))
    (_, drop, derived), = out["fig12"]
    want = fig12_draws(week_n, week_days)
    print(f"[examples] fleet_week: Fig 12 drop {drop:.4f}% ({derived}); "
          f"treated / control cluster-days of the numpy draws {want}",
          flush=True)
    if f"n=({want[0]},{want[1]})" not in derived:
        raise AssertionError(f"[examples] fleet_week: Fig 12 counts "
                             f"{derived}, the draws give {want}")
    all_finite("fleet_week", [drop, out["slo_violation_rate"]] + [
        v for d in out["week"] for v in (d["served"], d["carbon"],
                                         d["queue"])])

    out = record("scenario_sweep", run_example(
        "scenario_sweep (default library, 14 days x 4 seeds)",
        "scenario_sweep", [], [14 * SOLVE_ROUNDS, 0, 0, 0, 0]))
    check_sweep_rows("scenario_sweep", out["rows"])
    short = SWEEP_DAYS * SOLVE_ROUNDS
    out = record("scenario_sweep --risk", run_example(
        "scenario_sweep --risk", "scenario_sweep",
        ["--risk"] + SWEEP_SHORT, [short, 2 * short, 0, 0, 0]))
    check_sweep_rows("scenario_sweep --risk", out["rows"])
    steps = SWEEP_DAYS * JOINT_ROUNDS * JOINT_STEPS
    out = record("scenario_sweep --spatial", run_example(
        "scenario_sweep --spatial", "scenario_sweep",
        ["--spatial"] + SWEEP_SHORT, [2 * short, 0, steps, 0, 0],
        {"joint_step": {"fused": steps, "split": 0}}))
    check_sweep_rows("scenario_sweep --spatial", out["rows"])
    if len(out["rows"]) * SWEEP_SEEDS != SPATIAL_EXAMPLE_SHAPE[0]:
        raise AssertionError("[examples] the --spatial sweep's rollouts are "
                             "not SPATIAL_EXAMPLE_SHAPE's, at which "
                             "phase_joint_s holds #3")
    trace = ROOT / EXAMPLE_TRACE
    trace.parent.mkdir(exist_ok=True)
    tel = record("scenario_sweep --telemetry", run_example(
        "scenario_sweep --telemetry --trace", "scenario_sweep",
        ["--telemetry", "--trace", str(trace)] + SWEEP_SHORT,
        [short, 0, 0, 0, 0]))
    check_sweep_rows("scenario_sweep --telemetry", tel["rows"])
    for r in tel["telemetry_rows"]:
        all_finite(f"telemetry {r['scenario']}",
                   [v for v in r.values() if isinstance(v, float)])
    back = sim.read_jsonl(trace)
    names = [s.name for s in sim.default_library(SWEEP_DAYS)]
    print(f"[examples] scenario_sweep --telemetry: {len(back)} trace records "
          f"read back from {EXAMPLE_TRACE} (expected {len(names)} scenarios "
          f"x {SWEEP_SEEDS} seeds x {SWEEP_DAYS} days)", flush=True)
    if len(back) != len(names) * SWEEP_SEEDS * SWEEP_DAYS \
            or [r["scenario"] for r in back] \
            != [r["scenario"] for r in tel["records"]]:
        raise AssertionError("[examples] the trace did not read back")
    out = record("scenario_sweep --sharded", run_example(
        "scenario_sweep --sharded", "scenario_sweep",
        ["--sharded"] + SWEEP_SHORT, [short, 0, 0, 0, 0]))
    # the same batch: sharded == unsharded and telemetry on == off, both
    # bit for bit, so the two tables are equal
    if out["rows"] != tel["rows"]:
        raise AssertionError("[examples] the sharded sweep's table differs "
                             "from the telemetry run's")
    print("[examples] scenario_sweep --sharded: its table equals the "
          "telemetry run's (same batch)", flush=True)

    rounds, layers, gen = 4, 2, 16
    res = record("serve_shaped", run_example(
        "serve_shaped", "serve_shaped", [],
        [0, 0, 0, rounds * layers * (1 + gen), 0],
        {"flash_attention": {**no_flash, "flash_prefill": rounds * layers,
                             "flash_decode": rounds * layers * gen}}))
    gate = CarbonGate()
    if res.batches != [gate.admitted(r, 4) for r in range(rounds)]:
        raise AssertionError(f"[examples] serve_shaped: batches "
                             f"{res.batches}")
    all_finite("serve_shaped", res.prefill_ms + res.decode_ms)

    flash_ex = {case[0]: flash_case(card, *case)
                for case in EX_SERVE_CASES + [EX_TRAIN_CASE]}
    autograd = dict([train_example_function_cost(card)])
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    n_f32 = EX_TRAIN_STEPS * EX_TRAIN_LAYERS
    try:
        losses = record("train_carbon_aware", run_example(
            "train_carbon_aware", "train_carbon_aware",
            ["--ckpt-dir", str(EXAMPLE_CKPT)], [0, 0, 0, n_f32, 0],
            {"flash_attention": {**no_flash, "flash_attention": n_f32}}))
    finally:
        shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    all_finite("train_carbon_aware", losses)
    wall = walls["train_carbon_aware"]
    train_ms = flash_ex[EX_TRAIN_CASE[0]]["ms"]
    print(f"[examples] train_carbon_aware: {len(losses)} logged losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {EX_TRAIN_STEPS} steps in "
          f"{wall:.2f} s ({1e3 * wall / EX_TRAIN_STEPS:.1f} ms a step with "
          f"its checkpoints); #4 {EX_TRAIN_LAYERS} launches a step on "
          f"flash_attention.cu, {train_ms:.4f} ms each "
          f"({EX_TRAIN_LAYERS * train_ms:.2f} ms a step)", flush=True)
    fig12_card_vs_cpu()
    print(f"[examples] wall seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; the phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched, routes, flash_ex, autograd


GOLDEN_PROMPT = 40                     # [serve-golden]'s prompt tokens


def phase_serve_golden(gen=4):
    """The serving smoke configs in float32: the same weights on the card
    (kernels) and on the CPU (plain versions), logits of the prefill and
    ``gen`` decode steps within 1e-4 of max|logit|, greedy tokens equal
    wherever the CPU's top-2 margin exceeds that gap. Returns #5's calls
    by model and route on the card, counted from 0 (float32: all on
    ``gla_scan``; Zamba2 and RWKV6 must launch it)."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.kernels.linear_scan import kernel as gla_kernel
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    gla_kernel.gla_cuda.routes = dict.fromkeys(gla_kernel.SOURCES, 0)
    gla_by_model = {}
    for arch in SERVE_ARCHS:
        cfg = get_arch(arch).smoke.replace(remat="none", dtype="float32")
        cpu = build_model(cfg, "cpu", seed=3)
        gpu = copy.deepcopy(cpu).to("cuda")
        kw = dict(smoke=True, batch=4, prompt_len=GOLDEN_PROMPT,
                  gen=gen, rounds=2, carbon_aware=True, keep_logits=True,
                  verbose=False)
        # Gemma2's smoke window (16) binds in these prefills and decodes
        windowed_calls(arch, cpu, prompt=GOLDEN_PROMPT, gen=gen,
                       tag="[serve-golden]")
        before = dict(gla_kernel.gla_cuda.routes)
        got = serve(arch, device="cuda", model=gpu, **kw)
        gla = {r: gla_kernel.gla_cuda.routes[r] - before[r] for r in before}
        if any(gla.values()):
            gla_by_model[arch] = gla
        if any(n for r, n in gla.items() if r != "gla_scan") or (
                arch in ("zamba2-7b", "rwkv6-7b") and not gla["gla_scan"]):
            raise AssertionError(f"{arch}: float32 #5 calls by route {gla}")
        want = serve(arch, device="cpu", model=cpu, **kw)
        if got.batches != want.batches:
            raise AssertionError(f"{arch}: admitted {got.batches} on cuda, "
                                 f"{want.batches} on cpu")
        worst, ties = 0.0, 0
        for r in range(len(want.batches)):
            for step, (g, w) in enumerate(zip(got.logits[r],
                                              want.logits[r])):
                gap = (g - w).abs().max().item()
                scale = w.abs().max().item()
                worst = max(worst, gap / scale)
                if not gap <= 1e-4 * scale:
                    raise AssertionError(f"{arch}: round {r} step {step} "
                                         f"logit gap {gap:.3e} of {scale:.3e}")
                top2 = torch.topk(w, 2, -1).values
                decided = (top2[:, 0] - top2[:, 1]) > gap
                same = got.tokens[r][:, step] == want.tokens[r][:, step]
                if not same[decided].all():
                    raise AssertionError(f"{arch}: round {r} step {step} "
                                         "greedy tokens differ")
                if not decided.all():
                    ties += 1
                    break
        print(f"[serve-golden] {arch} smoke float32, cuda (kernels) vs cpu "
              f"(plain): admitted {got.batches}; largest logit gap "
              f"{worst:.3e} of max|logit| (limit 1e-4) over the prefill and "
              f"{gen} decode steps of each round; greedy tokens equal"
              + (f" (a tie cut {ties} round short)" if ties else "")
              + (f"; #5 calls by route {gla_by_model[arch]}"
                 if arch in gla_by_model else ""), flush=True)
    return gla_by_model


# ------------------------------------------------------------------ phase 6

# the golden configuration of tests/test_golden_trace.py and the
# end-to-end tolerances of tests/test_torch_rollout.py
GOLDEN_DAYS = 3
RTOL_KEYS = ("carbon_kg", "kwh", "cf_carbon_kg", "cf_kwh", "served",
             "arrived", "cf_served")
ATOL_KEYS = ("delayed_cpu_h", "cf_delayed_cpu_h")


def golden_rollout(device, slice_path=False, closed_loop=False,
                   telemetry=False):
    """The golden configuration; ``slice_path=True`` runs the slice's
    configuration (joint spatial, 8 members) at golden size over two
    scenarios of each sweep library instead, ``closed_loop=True`` the
    streaming closed loop (``streaming=True, mpc=True``) over
    ``forecast_bust_library``; ``telemetry=True`` also returns the trace
    records and the days' largest |delta|."""
    from repro_torch import sim
    kw = dict(joint_spatial=True, n_members=SLICE_MEMBERS) \
        if slice_path else dict(streaming=True, mpc=True) \
        if closed_loop else {}
    cfg = sim.SimConfig(n_clusters=8, n_campuses=2, n_zones=2,
                        pds_per_cluster=2, hist_days=14, telemetry=telemetry,
                        **kw)
    if slice_path:
        scenarios = sim.mobility_sweep_library(GOLDEN_DAYS, (0.0, 0.3)) \
            + sim.risk_sweep_library(GOLDEN_DAYS, (0.5, 0.9))
    elif closed_loop:
        scenarios = sim.forecast_bust_library(GOLDEN_DAYS)
    else:
        scenarios = [sim.Scenario("baseline", "nominal grid, nominal fleet"),
                     sim.Scenario("high_carbon_price", "lambda_e x4",
                                  lambda_e=2.0)]
    params = sim.build_batch(cfg, scenarios, (0, 1), GOLDEN_DAYS,
                             device=device)
    takes, margins, deltas = [], [], []

    def on_day(d, state, out):
        if out is not None and out.best is not None:
            takes.append(out.best.take.cpu())
            margins.append(out.best.margin.cpu())
        if out is not None:
            deltas.append(out.sol.delta.abs().max().item())

    state, ledger, traj = sim.rollout_batch(cfg, GOLDEN_DAYS, device=device,
                                            on_day=on_day)(params)
    best = (torch.stack(takes, 1), torch.stack(margins, 1)) if takes \
        else None
    if not telemetry:
        return state, ledger, best
    records = sim.telemetry_records(traj["telemetry"],
                                    [sc.name for sc in scenarios], 2)
    return state, ledger, best, records, max(deltas)


TIE_TOL = 1e-5      # a best-of call this close may fall either way


def check_verdicts(label, gpu, cpu):
    """The best-of verdicts of the golden-size slice, (rollout x day) on
    each device: some rollout-day keeps the joint point, and the devices
    agree on every call, except where a rollout's first differing call was
    a tie on both (|margin| <= TIE_TOL: float rounding decides it, and the
    rollout follows another plan from that day on)."""
    (gt, gm), (ct, cm) = gpu, cpu
    print(f"[{label}] rollout-days with the joint point kept (rollout x "
          f"day): cuda {gt.int().tolist()}, cpu {ct.int().tolist()}",
          flush=True)
    if not gt.any():
        raise AssertionError(f"{label}: no rollout-day kept the joint point")
    for r in torch.nonzero((gt != ct).any(1)).flatten().tolist():
        d = int(torch.nonzero(gt[r] != ct[r])[0])
        print(f"[{label}] rollout {r}, day {d}: the devices' calls differ "
              f"at margins cuda {gm[r, d]:.3e}, cpu {cm[r, d]:.3e} (a tie "
              f"within {TIE_TOL:g})", flush=True)
        if not max(abs(gm[r, d]), abs(cm[r, d])) <= TIE_TOL:
            raise AssertionError(f"{label}: the devices' best-of calls "
                                 f"differ on rollout {r}, day {d}, and it "
                                 "was no tie")


def check_trace_devices(label, got, want, n, delta_max):
    """The card's trace records against the CPU's, by the classes of
    tests/test_torch_telemetry_rollout.py: rates 1e-3 x max|cpu|; what
    passes admission 5e-2 x max|cpu|; the last step 2e-2 x max|delta|; the
    dual residual 1e-3; the conservation residual below 1e-5 on both; at
    most 2 flips of a 0/1 gauge; the best-of call equal."""
    gaps, flips, bad = {}, {}, []
    for f in TRACE_FIELDS_COMPARED:
        g = torch.tensor([r[f] for r in got], dtype=torch.float64)
        w = torch.tensor([r[f] for r in want], dtype=torch.float64)
        gap = (g - w).abs().max().item()
        scale = max(w.abs().max().item(), 1e-30)
        gaps[f] = gap / scale
        if f in TEL_RATE:
            ok = gap <= 1e-3 * scale
        elif f in TEL_ADMITTED:
            ok = gap <= 5e-2 * scale
        elif f == "step_final":
            ok = gap <= 2e-2 * delta_max
        elif f == "dual_max":
            ok = gap <= 1e-3
        elif f == "conservation_max":
            ok = g.max().item() < 1e-5 and w.max().item() < 1e-5
        elif f in TEL_GAUGES:
            flips[f] = int(torch.round((g - w).abs() * n * TEL_GAUGES[f]
                                       ).sum().item())
            ok = flips[f] <= 2
        else:
            ok = gap == 0.0
        if not ok:
            bad.append(f"{f} (gap {gap:.3e} of {scale:.3e})")
    print(f"[{label}] telemetry trace, cuda vs cpu, {len(got)} records, "
          "largest gap relative to the largest value: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f"; 0/1 gauge flips {flips}", flush=True)
    if bad:
        raise AssertionError(f"[{label}] telemetry beyond its class: "
                             + ", ".join(bad))


TRACE_FIELDS_COMPARED = TEL_RATE + TEL_ADMITTED + (
    "step_final", "dual_max", "conservation_max", "joint_winner") \
    + tuple(TEL_GAUGES)


def phase_cross_device(slice_path=False, closed_loop=False, telemetry=False):
    label = "golden slice" if slice_path else "golden closed loop" \
        if closed_loop else "golden"
    t0 = time.perf_counter()
    gpu = golden_rollout("cuda", slice_path, closed_loop, telemetry)
    cpu = golden_rollout("cpu", slice_path, closed_loop, telemetry)
    (gpu_state, gpu_led, gpu_best), (cpu_state, cpu_led, cpu_best) = \
        gpu[:3], cpu[:3]
    if telemetry:
        check_trace_devices(label, gpu[3], cpu[3], 8, max(gpu[4], cpu[4]))
    if slice_path:
        check_verdicts(label, gpu_best, cpu_best)
    gaps = {}
    for key in RTOL_KEYS + ATOL_KEYS:
        got = getattr(gpu_led, key).cpu().double()
        want = getattr(cpu_led, key).double()
        gap = (got - want).abs().max().item()
        scale = want.abs().max().item()
        gaps[key] = gap / max(scale, 1e-12)
        limit = 1e-3 if key in RTOL_KEYS else 5e-2
        if not gap <= limit * max(scale, 1e-12) + 1e-12:
            raise AssertionError(f"{label} {key}: cuda vs cpu gap "
                                 f"{gap:.3e} beyond {limit:g} x {scale:.3g}")
    got, want = gpu_state.queue.cpu().double(), cpu_state.queue.double()
    gaps["queue"] = (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-12)
    if gaps["queue"] > 5e-2:
        raise AssertionError(f"{label} queue gap {gaps['queue']:.3e}")
    print(f"[{label}] cuda (kernels) vs cpu (plain), largest gap relative "
          "to the largest value: " + ", ".join(f"{k} {v:.3e}"
                                              for k, v in gaps.items())
          + f"; {time.perf_counter() - t0:.2f} s", flush=True)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--gla-parent", metavar="DIR", default=None,
                    help="a directory holding an earlier gla_scan.cu (the "
                         "parent commit's), timed in turns with kernel "
                         "#5's split-TF32 route at each of its cases")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    last = [t0]

    def lap(what):
        now = time.perf_counter()
        print(f"[time] {what}: {now - last[0]:.1f} s (at {now - t0:.1f} s)",
              flush=True)
        last[0] = now
    name, sms, clock_mhz = phase_device()
    card = Card(sms, clock_mhz)
    phase_build()
    lap("[build]")
    joint, s_project = phase_joint_kernel(card)
    records = [phase_kernels(card), phase_ens_kernel(card), joint]
    lap("[kernel] #1 to #3")
    records.append(phase_flash_kernel(card))
    lap("[kernel] #4")
    records += [*phase_gla_kernel(card, args.gla_parent), s_project]
    lap("[kernel] #5")
    # #5's RWKV6 route (gla_vec.cu): a record of its own, moved last
    records.append(records.pop(5))
    records[0]["launches"] = phase_main_path()
    phase_sharded()
    phase_calibrate()
    counts, _ = phase_slice_path()
    # kernel #1 counts on the main path; #2 and #3 (by route) and the split
    # route's s_project on the slice path; #4 and #5 on the serving and
    # training paths
    records[1]["launches"], records[2]["launches"] = counts[1], counts[2]
    records[2]["launches_by_route"] = counts[5]
    records[5]["launches"] = counts[6]
    # #1's launches and its suffix epoch on the closed-loop path
    records[0].update(phase_closed_loop(card))
    phase_telemetry()
    lap("the main, slice, closed-loop, telemetry and fleet phases")
    serving, records[3]["launches_by_route"], \
        records[4]["launches_by_route"], gla_serve, fa_serve = phase_serve()
    lap("[serve]")
    # #4 and #5 run on two paths, each counted from 0: serving and training
    training, gla_train, fa_train, autograd = phase_train(card)
    lap("[train]")
    # the examples, each counted from 0: #1 to #4 by example (and #3's
    # and #4's routes); #4's examples' launches join its serve and train
    ex_launched, ex_routes, flash_ex, ex_autograd = phase_examples(card)
    lap("[examples]")
    # #4's autograd Function: its forward + backward by case
    records[3]["autograd_by_case"] = {**autograd, **ex_autograd}
    for i, rec in enumerate(records[:4]):
        rec["launches_by_example"] = {k: c[i] for k, c in ex_launched.items()
                                      if c[i]}
    records[2]["launches_by_example_route"] = {
        k: r["joint_step"] for k, r in ex_routes.items()
        if ex_launched[k][2]}
    records[3]["launches_by_example_route"] = {
        k: r["flash_attention"] for k, r in ex_routes.items()
        if ex_launched[k][3]}
    for label, rec in flash_ex.items():
        records[3]["by_case"][label] = case_row(rec)
    examples = [sum(c[i] for c in ex_launched.values()) for i in (3, 4)]
    records[3]["launches_by_path_model"] = {"serve": fa_serve,
                                            "train": fa_train}
    for rec, s, t, e in zip(records[3:5], serving, training, examples):
        rec["launches"] = s + t + e
        rec["launches_by_path"] = {"serve": s, "train": t, "examples": e}
    records[4]["launches_by_path_model_route"] = {"serve": gla_serve,
                                                  "train": gla_train}
    vec = {path: sum(r.get("gla_vec", 0) for r in by_model.values())
           for path, by_model in (("serve", gla_serve), ("train", gla_train))}
    records[6]["launches"] = vec["serve"] + vec["train"]
    records[6]["launches_by_path"] = vec
    phase_cross_device(telemetry=True)
    phase_cross_device(slice_path=True)
    phase_cross_device(closed_loop=True, telemetry=True)
    lap("[golden]")
    records[4]["launches_by_path_model_route"]["serve_golden"] = \
        phase_serve_golden()
    lap("[serve-golden]")
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
