#!/usr/bin/env python3
"""Time the layout choices of kernels #1 and #2 (the PGD epochs) on one card.

    python3 tools/pgd_probe.py [--rounds 2]

Builds ``kernels/vcc_pgd/csrc/pgd_epoch.cu`` and ``pgd_epoch_ens.cu`` from
the repository's sources for every lanes-a-row ``PGD_LANES`` in 1, 2, 4, 8
with the bisection's early exit on and off (``PGD_EARLY_EXIT``; each build
holds only the instance of H = 24, ``PGD_ONLY_NH``), and the shipped build,
into ``build/`` (in parallel, ptxas registers and spills printed). Then, on
the inputs of ``chip_smoke.py``, at the paths' shapes (#1 at the main
path's 22,528 rows and the slice path's 14,336; #2 at 14,336 rows and K =
8, iters = 80), it checks every build against the plain version (1e-4 on
delta; each early-exit build bitwise against its fixed-count twin) and
times the builds in alternating rounds (A B ..., then ... B A) with CUDA
events (median of 20 after a spin ahead). The summary goes to
``chiprun_out/pgd_probe.json``.
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
LANES = (1, 2, 4, 8)


def variants():
    """name: -D defines; "shipped" is the build the wrappers launch."""
    out = {"shipped": ()}
    for lanes in LANES:
        for early in (0, 1):
            out[f"L={lanes} exit={early}"] = (
                f"PGD_LANES={lanes}", f"PGD_EARLY_EXIT={early}",
                f"PGD_ONLY_NH={-(-H // lanes)}")
    return out


def build_all():
    """{(source, variant name): entry point}, compiled in parallel."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = [(src, name, defs) for src in ("pgd_epoch", "pgd_epoch_ens")
            for name, defs in variants().items()]

    def one(job):
        src, name, defs = job
        _, secs, log = kernel.build(src, verbose=True, defines=defs)
        info = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[probe] build {src} {name}: {secs:.1f} s; {info}",
              flush=True)
        return (src, name), kernel.variant(src, defs)

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(one, jobs))


def cases(dev):
    """(label, source, launch, plain): the paths' shapes."""
    out = []
    for rows in (cs.MAIN_ROWS, cs.SLICE_ROWS):
        args, temp, lame = cs.random_rows(rows, rows, dev)
        out.append((
            f"#1 rows={rows}", "pgd_epoch",
            lambda a=args, t=temp, la=lame: kernel.pgd_epoch_cuda(
                *a, t, la, iters=cs.ITERS),
            lambda a=args, t=temp, la=lame: ref.pgd_epoch_ref(
                *a, temp=t, lambda_e=la, iters=cs.ITERS)))
    rows, K = cs.SLICE_ROWS, cs.SLICE_MEMBERS
    args, eta_e, pow_e, temp, lame, risk_s, B = cs.random_members(
        rows, K, rows + K, dev)
    d, _, pi, _, tau24, price, lo, ub, lr = args

    def b3(x):
        return x.reshape(B, rows // B, x.shape[-1])

    out.append((
        f"#2 rows={rows} K={K}", "pgd_epoch_ens",
        lambda: kernel.pgd_epoch_ens_cuda(
            d, eta_e, pi, pow_e, tau24, price, lo, ub, lr, temp, lame,
            risk_s, iters=cs.ITERS),
        lambda: ref.pgd_epoch_ens_ref(
            b3(d), eta_e, b3(pi), pow_e, b3(tau24), b3(price), b3(lo),
            b3(ub), b3(lr), temp=b3(temp), lambda_e=b3(lame),
            risk_s=b3(risk_s), iters=cs.ITERS).reshape(rows, -1)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        raise SystemExit("pgd_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build_all()
    names = list(variants())
    result = {"card": card, "cases": {}}
    for label, src, run, plain in cases(torch.device("cuda")):
        want = plain()
        row = {}
        outs = {}
        for n in names:
            kernel._libs[src] = libs[(src, n)]
            outs[n] = run()
            torch.cuda.synchronize()
            err = (outs[n] - want).abs().max().item()
            if not err <= cs.KERNEL_TOL:
                raise AssertionError(f"{label}, {n}: error {err:.3e}")
            row[n] = {"max_abs_err": err, "ms": []}
        for lanes in LANES:
            fixed, early = outs[f"L={lanes} exit=0"], outs[f"L={lanes} exit=1"]
            same = torch.equal(fixed.view(torch.int32),
                               early.view(torch.int32))
            row[f"L={lanes} exit=1"]["bitwise_vs_fixed"] = same
            if not same:
                raise AssertionError(f"{label}, L={lanes}: the early exit "
                                     "changed the result")
        for r in range(rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                kernel._libs[src] = libs[(src, n)]
                row[n]["ms"].append(cs.cuda_ms(run, lead=True))
        kernel._libs.pop(src)
        result["cases"][label] = row
        print(f"[probe] {label}: " + "; ".join(
            f"{n} {[round(t, 4) for t in x['ms']]} ms (error "
            f"{x['max_abs_err']:.3e})" for n, x in row.items()), flush=True)
        del want, outs
    print(f"[probe] {card}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "pgd_probe.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
