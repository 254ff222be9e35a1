#!/usr/bin/env python3
"""Time the staging depth of kernel #5's tensor-core route on one card.

    python3 tools/gla_probe.py [--rounds 2]

Builds ``kernels/linear_scan/csrc/gla_ssd.cu`` from the repository's
sources as shipped (one staged q, k and v tile) and with
``-DGLA_STAGES=2`` (q, k and v double-buffered with ``cp.async``), into
``build/`` (in parallel, ptxas registers and spills printed).
Then, at Zamba2-7B's Mamba2 prefill (4 x 1,024 tokens, 112 heads, K = V =
64, q and k broadcast over the heads; ``chip_smoke.py``'s inputs), it
checks every build against the plain version at ``chip_smoke.py``'s limit
and times the builds in alternating rounds (A B ..., then ... B A) with
CUDA events (median of 20 after a spin ahead). The summary goes to
``chiprun_out/gla_probe.json``.
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

from repro_torch.kernels.linear_scan import kernel, ref  # noqa: E402

VARIANTS = {"shipped": (), "two stages": ("GLA_STAGES=2",)}


def build_all():
    """{variant name: entry points}, compiled in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        name, defs = item
        _, secs, log = kernel.build("gla_ssd", verbose=True, defines=defs)
        info = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[probe] build {name}: {secs:.1f} s; {info}", flush=True)
        return name, kernel.variant("gla_ssd", defs)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(one, VARIANTS.items()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        raise SystemExit("gla_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    libs = build_all()
    B, S, H, K, V = cs.SERVE_BATCH, cs.SERVE_PROMPT, 112, 64, 64
    q, k, v, ld, _, _ = cs.gla_inputs(B, S, H, K, V, torch.bfloat16,
                                      "scalar", False, torch.device("cuda"),
                                      100)

    def run():
        return kernel.gla_cuda(q, k, v, ld, chunk=256)

    wo, whT = ref.gla_chunked(q, k, v, ld, chunk=256)
    o_scale, s_scale = wo.float().abs().max().item(), whT.abs().max().item()
    result = {"card": card, "shape": [B, S, H, K, V], "variants": {}}
    for name in VARIANTS:
        kernel._libs["gla_ssd"] = libs[name]
        o, hT = run()
        torch.cuda.synchronize()
        err = (o.float() - wo.float()).abs()
        excess = (err - cs.GLA_RTOL * o_scale
                  - 2.0 ** -7 * wo.float().abs()).max().item()
        s_err = (hT - whT).abs().max().item()
        if not (excess <= 0.0 and s_err <= cs.GLA_RTOL * s_scale):
            raise AssertionError(f"{name}: disagrees with plain "
                                 f"({err.max().item():.3e}, {s_err:.3e})")
        result["variants"][name] = {"max_abs_err": err.max().item(),
                                    "state_err": s_err, "ms": []}
    names = list(VARIANTS)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            kernel._libs["gla_ssd"] = libs[name]
            result["variants"][name]["ms"].append(cs.cuda_ms(run, lead=True))
    kernel._libs.pop("gla_ssd")
    for name, x in result["variants"].items():
        print(f"[probe] {name}: {[round(t, 4) for t in x['ms']]} ms (error "
              f"{x['max_abs_err']:.3e} of max|o| {o_scale:.3e}, state "
              f"{x['state_err']:.3e})", flush=True)
    print(f"[probe] {card}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gla_probe.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
