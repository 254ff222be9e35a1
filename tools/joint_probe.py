#!/usr/bin/env python3
"""Time the design choices of kernel #3 (the joint step) on one card.

    python3 tools/joint_probe.py [--rounds 2]

Builds ``kernels/vcc_pgd/csrc/joint_step.cu`` from the repository's sources
as shipped, with 8 lanes a row (``PGD_LANES=8``), with the bisections'
early exit off (``PGD_EARLY_EXIT=0``) and with the shift's bisection
reading every cluster from shared memory (``JOINT_SHIFT_REGS=0``; each
variant holds only the instance of H = 24, ``PGD_ONLY_NH``), into
``build/`` (in parallel, ptxas registers and spills printed). Then, on
``chip_smoke.py``'s inputs at the slice path's 28 rollouts x 512
clusters, it runs:

* the fused route (one launch a step) at C = 2, 4 and 8 blocks a rollout
  (``block_rows`` 256, 128, 64) on the shipped build, and at C = 4 on each
  variant;
* the split route (the step's kernel, then ``s_project``: two launches) on
  each build, and the split route's step alone.

It checks every case against ``ref.joint_step_s_arrays`` (d' within 1e-5,
s' within 1e-5 x max|z| plus the bracket's width; the early-exit-off and
shared-memory builds bitwise against the shipped one) and times the cases
in alternating rounds (A B ..., then ... B A) with CUDA events (median of
20 after a spin ahead).
The summary goes to ``chiprun_out/joint_probe.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

from repro_torch.kernels.vcc_pgd import kernel, ref  # noqa: E402

H = 24
ENTRIES = ("joint_step_s", "joint_step", "s_project")
BUILDS = {"shipped": (),
          "L=8": ("PGD_LANES=8", f"PGD_ONLY_NH={-(-H // 8)}"),
          "exit off": ("PGD_EARLY_EXIT=0", f"PGD_ONLY_NH={-(-H // 4)}"),
          "shift in smem": ("JOINT_SHIFT_REGS=0",
                            f"PGD_ONLY_NH={-(-H // 4)}")}
# the builds that must give the shipped build's bits
SAME_BITS = ("exit off", "shift in smem")


def build_all():
    """{build name: {entry: entry point}}, compiled in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        name, defs = item
        _, secs, log = kernel.build("joint_step", verbose=True, defines=defs)
        info = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[probe] build {name}: {secs:.1f} s; {info}", flush=True)
        return name, {e: kernel.variant(e, defs) for e in ENTRIES}

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        return dict(pool.map(one, BUILDS.items()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        raise SystemExit("joint_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build_all()
    B, n, drop = cs.SLICE_ROLLOUTS, cs.MAIN_CLUSTERS, 0.8
    kern = cs.random_joint_s(B, n, B * n, torch.device("cuda"))
    pl = [x.reshape(B, n, x.shape[-1]) for x in kern[:-1]] + [kern[-1]]
    wd, ws = ref.joint_step_s_arrays(*pl, drop_limit=drop)
    _, wg = ref.joint_step_arrays(*pl[:15], drop_limit=drop)
    z = pl[1][..., 0] - pl[-1] * wg[..., 0]
    nu = torch.empty(B * 8, 2, device="cuda")
    # the rows of nu each case writes: (nu, bracket width) a block
    blocks = {}

    def fused(block_rows):
        C = kernel.joint_plan(n, block_rows)[1]

        def run():
            blocks[run] = B * C
            return kernel.joint_step_s_cuda(
                *kern, n=n, drop_limit=drop, block_rows=block_rows,
                nu_out=nu[:B * C])
        return run

    def split():
        blocks[split] = B
        d, g = kernel.joint_step_cuda(*kern[:15], drop_limit=drop)
        return d, kernel.s_project_cuda(kern[1], g, kern[17], kern[15],
                                        kern[16], n=n, nu_out=nu[:B])

    def step_alone():
        return kernel.joint_step_cuda(*kern[:15], drop_limit=drop)

    cases = {f"fused C={kernel.joint_plan(n, br)[1]} (R={br}), shipped":
             ("shipped", fused(br)) for br in (128, 256, 64)}
    for b in BUILDS:
        if b != "shipped":
            cases[f"fused C=4 (R=128), {b}"] = (b, fused(128))
    for b in BUILDS:
        cases[f"split (two launches), {b}"] = (b, split)
    cases["split route's step alone, shipped"] = ("shipped", step_alone)

    result = {"card": card, "shape": [B, n, H], "cases": {}}
    outs = {}
    for label, (b, run) in cases.items():
        kernel._libs.update(libs[b])
        out = run()
        torch.cuda.synchronize()
        row = {"build": b, "ms": []}
        if "alone" not in label:
            d, s2 = out
            row["d_err"] = (d - wd.reshape(B * n, -1)).abs().max().item()
            width = nu[:blocks[run], 1].max().item()
            row["s_err"], row["s_limit"] = cs.shift_check(
                label, B, n, s2.reshape(B, n), ws[..., 0], z, width,
                pl[15][..., 0], pl[16][..., 0])[:2]
            if not row["d_err"] <= cs.JOINT_TOL:
                raise AssertionError(f"{label}: d' error {row['d_err']:.3e}")
            outs[label] = [x.view(torch.int32).clone() for x in out]
        result["cases"][label] = row
    for route in ("fused C=4 (R=128)", "split (two launches)"):
        shipped = outs[f"{route}, shipped"]
        for b in SAME_BITS:
            same = all(torch.equal(x, y)
                       for x, y in zip(outs[f"{route}, {b}"], shipped))
            result["cases"][f"{route}, {b}"]["bitwise_vs_shipped"] = same
            if not same:
                raise AssertionError(f"{route}, {b}: not the shipped "
                                     "build's bits")
    names = list(cases)
    for r in range(rounds):
        for label in (names if r % 2 == 0 else names[::-1]):
            b, run = cases[label]
            kernel._libs.update(libs[b])
            result["cases"][label]["ms"].append(cs.cuda_ms(run, lead=True))
    for e in ENTRIES:
        kernel._libs.pop(e, None)
    for label, row in result["cases"].items():
        print(f"[probe] {label}: {[round(t, 4) for t in row['ms']]} ms"
              + (f" (d' error {row['d_err']:.3e}, s' error "
                 f"{row['s_err']:.3e} of limit {row['s_limit']:.3e})"
                 if "d_err" in row else ""), flush=True)
    print(f"[probe] {card}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "joint_probe.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
