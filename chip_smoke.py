#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN;
2. build: ``nvcc`` compiles every kernel of the port from ``csrc/`` into
   ``build/`` (one compiler process per source, all started together);
3. kernels against their plain versions on the card, at iters = 80 and
   three row counts (ragged, the main path's, fleet scale): max error,
   conservation residual, bound violations, kernel and plain times (CUDA
   events, median of 20 after warm-up) and the least time the card could
   take for the same work;
4. main path: ``sim.rollout_batch`` over ``default_library(7)`` x seeds 0-3
   for 7 days at 512 clusters, 64 campuses, 16 zones on the card, with the
   kernel launch counts, finiteness, and conservation and bounds of every
   day's solution checked; then one more day under ``torch.profiler``
   (device busy share, top ops; full table in chiprun_out/);
5. the golden configuration on the card (kernel) against the CPU (plain
   version), within the parity tests' end-to-end tolerances;
6. one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one, and without the repo's
``src/`` beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
KERNEL_TOL = 1e-4                    # max |kernel - plain| on delta
ITERS = 80
# the main path: default_library's 11 scenarios x 4 seeds x 512 clusters
MAIN_DAYS = 7
MAIN_SEEDS = (0, 1, 2, 3)
MAIN_CLUSTERS = 512
MAIN_ROWS = 11 * len(MAIN_SEEDS) * MAIN_CLUSTERS
KERNEL_ROWS = (1000, MAIN_ROWS, 131072)  # ragged, main path, fleet scale


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    builders = {"vcc_pgd_epoch": pgd_kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futs = {k: pool.submit(b, verbose=True) for k, b in builders.items()}
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


def phase_kernels(sms, clock_mhz):
    from repro_torch.kernels.vcc_pgd import kernel as pgd_kernel
    from repro_torch.kernels.vcc_pgd import ref as pgd_ref
    dev = torch.device("cuda")
    # FP32 peak: every SM issues 128 FP32 lanes a clock, an FMA counting
    # as two operations (67 TFLOP/s on a 132-SM H100 SXM at 1980 MHz)
    fp32_per_s = sms * 128 * 2 * clock_mhz * 1e6
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
        resid = got.sum(-1).abs().max().item()
        viol = torch.clamp(torch.maximum(lo - got, got - ub), min=0.0
                           ).max().item()
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        flops = pgd_kernel.epoch_flops(rows, 24, ITERS)
        nbytes = pgd_kernel.epoch_bytes(rows, 24)
        ops_ms, bytes_ms = 1e3 * flops / fp32_per_s, 1e3 * nbytes / \
            HBM_BYTES_PER_S
        bound_ms = max(ops_ms, bytes_ms)
        # what this one-warp-per-row design issues beyond the arithmetic:
        # an SM issues one warp shuffle per clock
        shfl_ms = 1e3 * pgd_kernel.epoch_shuffles(rows, ITERS) / (
            sms * clock_mhz * 1e6)
        print(f"[kernel] vcc_pgd_epoch rows={rows}: "
              f"max|kernel-plain|={err:.3e}"
              f" (limit {KERNEL_TOL:g}), conservation max|sum_h d|="
              f"{resid:.3e}, bound violation {viol:.3e}; kernel {ms:.4f} ms,"
              f" plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"(ops {flops:.4g} -> {ops_ms:.4f} ms, bytes {nbytes:.4g} -> "
              f"{bytes_ms:.4f} ms); the design's shuffle-issue floor "
              f"{shfl_ms:.4f} ms", flush=True)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with plain at rows={rows}")
        if not (resid <= 1e-4 * max(ub.abs().max().item(), 1.0)
                and viol <= 1e-6):
            raise AssertionError(f"kernel output infeasible at rows={rows}")
        if rows == MAIN_ROWS:
            record = {"name": "vcc_pgd_epoch", "route": "cuda",
                      "source": "src/repro_torch/kernels/vcc_pgd/csrc/"
                                "pgd_epoch.cu",
                      "replaces": "src/repro/kernels/vcc_pgd/kernel.py:122",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "operations" if ops_ms >= bytes_ms
                      else "bytes",
                      "library_ms": None}
    return record


# ------------------------------------------------------------------ phase 4

SOLVE_ROUNDS = 20                    # solve_vcc's dual-ascent rounds a day


def check_day(d, out):
    """Every day's solution conserves and stays within its bounds."""
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
        else:
            checks.append(check_day(d, out))

    run = sim.rollout_batch(cfg, MAIN_DAYS, device="cuda", on_day=on_day)
    pgd_kernel.pgd_epoch_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, ledger, traj = run(params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = pgd_kernel.pgd_epoch_cuda.launches
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
    profile_day(cfg, params, state)
    return launches


def profile_day(cfg, params, state):
    """One more day under torch.profiler, after the counted run: the
    device's busy share of the day's wall time and the ops that take it.
    The full table goes to chiprun_out/profile_day.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import sim
    from repro_torch.sim import engine
    step = sim.make_day_step(cfg)
    xs = engine.day_xs(params, MAIN_DAYS - 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, xs)
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
    print(f"[profile] one day step: wall {wall_ms:.1f} ms under the "
          f"profiler, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%) in {sum(e.count for e in kernels)}"
          " kernel launches; device time by launcher: "
          + "; ".join(f"{e.key.split('(float')[0][:48]} "
                      f"{self_dev_us(e) / 1e3:.1f} ms x{e.count}"
                      for e in top), flush=True)
    sort_key = "self_device_time_total" if hasattr(
        top[0], "self_device_time_total") else "self_cuda_time_total"
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_day.txt").write_text(events.table(sort_by=sort_key,
                                                      row_limit=40))


# ------------------------------------------------------------------ phase 5

# the golden configuration of tests/test_golden_trace.py and the
# end-to-end tolerances of tests/test_torch_rollout.py
GOLDEN_DAYS = 3
RTOL_KEYS = ("carbon_kg", "kwh", "cf_carbon_kg", "cf_kwh", "served",
             "arrived", "cf_served")
ATOL_KEYS = ("delayed_cpu_h", "cf_delayed_cpu_h")


def golden_rollout(device):
    from repro_torch import sim
    cfg = sim.SimConfig(n_clusters=8, n_campuses=2, n_zones=2,
                        pds_per_cluster=2, hist_days=14)
    scenarios = [sim.Scenario("baseline", "nominal grid, nominal fleet"),
                 sim.Scenario("high_carbon_price", "lambda_e x4",
                              lambda_e=2.0)]
    params = sim.build_batch(cfg, scenarios, (0, 1), GOLDEN_DAYS,
                             device=device)
    return sim.rollout_batch(cfg, GOLDEN_DAYS, device=device)(params)


def phase_cross_device():
    t0 = time.perf_counter()
    gpu_state, gpu_led, _ = golden_rollout("cuda")
    cpu_state, cpu_led, _ = golden_rollout("cpu")
    gaps = {}
    for key in RTOL_KEYS + ATOL_KEYS:
        got = getattr(gpu_led, key).cpu().double()
        want = getattr(cpu_led, key).double()
        gap = (got - want).abs().max().item()
        scale = want.abs().max().item()
        gaps[key] = gap / max(scale, 1e-12)
        limit = 1e-3 if key in RTOL_KEYS else 5e-2
        if not gap <= limit * max(scale, 1e-12) + 1e-12:
            raise AssertionError(f"golden {key}: cuda vs cpu gap {gap:.3e} "
                                 f"beyond {limit:g} x {scale:.3g}")
    got, want = gpu_state.queue.cpu().double(), cpu_state.queue.double()
    gaps["queue"] = (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-12)
    if gaps["queue"] > 5e-2:
        raise AssertionError(f"golden queue gap {gaps['queue']:.3e}")
    print("[golden] cuda (kernel) vs cpu (plain), largest gap relative to "
          "the largest value: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in gaps.items())
          + f"; {time.perf_counter() - t0:.2f} s", flush=True)


def main():
    name, sms, clock_mhz = phase_device()
    phase_build()
    record = phase_kernels(sms, clock_mhz)
    record["launches"] = phase_main_path()
    phase_cross_device()
    print(json.dumps({"kernels": [record]}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
