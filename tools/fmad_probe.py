#!/usr/bin/env python3
"""Time the three VCC PGD kernels built with and without ``-fmad=false``.

    python3 tools/fmad_probe.py [--rounds 3]

Builds every source of ``kernels/vcc_pgd/csrc`` twice into ``build/``: with
``kernel.NVCC_FLAGS`` less ``-fmad=false`` (nvcc contracts a multiply and an
add into one FMA) and with it (every multiply and add stays an IEEE
operation). On one CUDA card it then times, alternating the two builds
round by round (A B, B A, ...), kernel #1 at the main path's 22,528 rows,
#2 at the slice path's 14,336 rows and K = 8, and #3 at 14,336 rows, on the
inputs of ``chip_smoke.py`` (CUDA events, median of 20 after a spin ahead).
Each build's max error against the plain version and its gap between #2 over
identical members and #1 are printed too. The summary goes to
``chiprun_out/fmad_probe.json``.
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

NOFMA = "-fmad=false"


def use(flags):
    """Point the wrappers at the libraries built with ``flags``."""
    kernel.NVCC_FLAGS = flags
    kernel._libs.clear()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        raise SystemExit("fmad_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    base = tuple(f for f in kernel.NVCC_FLAGS if f != NOFMA)
    builds = {"fma": base, "nofma": base + (NOFMA,)}
    for flags in builds.values():
        use(flags)
        for name in kernel.SOURCES:
            kernel.build(name)
    dev = torch.device("cuda")

    # inputs and plain answers, once
    a1, temp1, lam1 = cs.random_rows(cs.MAIN_ROWS, cs.MAIN_ROWS, dev)
    a2, eta_e, pow_e, temp2, lam2, rs2, B = cs.random_members(
        cs.SLICE_ROWS, cs.SLICE_MEMBERS, cs.SLICE_ROWS + cs.SLICE_MEMBERS,
        dev)
    d2, _, pi2, _, t24, pr2, lo2, ub2, lr2 = a2
    a3 = cs.random_joint(cs.SLICE_ROWS, cs.SLICE_ROWS, dev)
    b3 = (B, cs.SLICE_ROWS // B)

    def r3(x):
        return x.reshape(*b3, x.shape[-1])

    want = {
        "pgd_epoch": ref.pgd_epoch_ref(*a1, temp=temp1, lambda_e=lam1,
                                       iters=cs.ITERS),
        "pgd_epoch_ens": ref.pgd_epoch_ens_ref(
            r3(d2), eta_e, r3(pi2), pow_e, r3(t24), r3(pr2), r3(lo2),
            r3(ub2), r3(lr2), temp=r3(temp2), lambda_e=r3(lam2),
            risk_s=r3(rs2), iters=cs.ITERS).reshape(cs.SLICE_ROWS, -1),
        "joint_step": ref.joint_step_arrays(*a3, drop_limit=0.8)[0]}
    ai, tempi, lami = cs.random_rows(cs.SLICE_ROWS, 5, dev)
    di, etai, pii, pni, t24i, pri, loi, ubi, lri = ai
    runs = {
        "pgd_epoch": lambda: kernel.pgd_epoch_cuda(*a1, temp1, lam1,
                                                   iters=cs.ITERS),
        "pgd_epoch_ens": lambda: kernel.pgd_epoch_ens_cuda(
            d2, eta_e, pi2, pow_e, t24, pr2, lo2, ub2, lr2, temp2, lam2,
            rs2, iters=cs.ITERS),
        "joint_step": lambda: kernel.joint_step_cuda(
            *a3, drop_limit=0.8)[0]}

    result = {"card": card, "rows": {"pgd_epoch": cs.MAIN_ROWS,
                                     "pgd_epoch_ens": cs.SLICE_ROWS,
                                     "joint_step": cs.SLICE_ROWS},
              "K": cs.SLICE_MEMBERS,
              "builds": {b: {"flags": " ".join(f), "ms": {k: [] for k in runs}}
                         for b, f in builds.items()}}
    for b, flags in builds.items():
        use(flags)
        err = {k: (fn() - want[k]).abs().max().item() for k, fn in
               runs.items()}
        ens = kernel.pgd_epoch_ens_cuda(
            di, etai.expand(1, cs.SLICE_MEMBERS, -1, -1).contiguous(), pii,
            pni.expand(1, cs.SLICE_MEMBERS, -1, -1).contiguous(), t24i, pri,
            loi, ubi, lri, tempi, lami, torch.full_like(tempi, 4.0),
            iters=cs.ITERS)
        one = kernel.pgd_epoch_cuda(*ai, tempi, lami, iters=cs.ITERS)
        gap = (ens - one).abs().max().item()
        result["builds"][b].update(max_abs_err=err, identical_gap=gap)
        print(f"[fmad] {b}: max|kernel-plain| "
              + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
              + f"; #2 over {cs.SLICE_MEMBERS} identical members vs #1: "
              f"{gap:.3e}", flush=True)
    order = list(builds)
    for r in range(rounds):
        for b in (order if r % 2 == 0 else order[::-1]):
            use(builds[b])
            for k, fn in runs.items():
                result["builds"][b]["ms"][k].append(cs.cuda_ms(fn, lead=True))
    for b in builds:
        print(f"[fmad] {b}: ms per launch over {rounds} rounds: "
              + "; ".join(f"{k} {v}" for k, v in
                          result["builds"][b]["ms"].items()), flush=True)
    print(f"[fmad] {card}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fmad_probe.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
