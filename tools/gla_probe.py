#!/usr/bin/env python3
"""Time the layout variants of kernel #5's tensor-core routes on one card.

    python3 tools/gla_probe.py [--route ssd|vec] [--rounds 2] [--clocks]

``--route ssd`` (the default) builds ``kernels/linear_scan/csrc/gla_ssd.cu``
as shipped (one staged q, k and v tile) and with ``-DGLA_STAGES=2`` (q, k
and v double-buffered with ``cp.async``) and times them at Zamba2-7B's
Mamba2 prefill (4 x 1,024 tokens, 112 heads, K = V = 64, q and k broadcast
over the heads).

``--route vec`` builds ``csrc/gla_vec.cu`` as shipped (one block of four
warps per (batch, head), the next tile loaded while this one's products
run), with ``-DGLA_VSPLIT=2`` (the value columns split over two blocks per
(batch, head), each forming A again) and with ``-DGLA_PREFETCH=0`` (the
next tile loaded after this one's products), and times them with the
CUDA-core source ``gla_scan.cu`` at RWKV6-7B's serving prefill (4 x 1,024
tokens, 64 heads, K = V = 64, per-channel decay, bonus, strict).

Every build goes into ``build/`` (in parallel, ptxas registers and spills
printed), is checked against the plain version at ``chip_smoke.py``'s
limit on ``chip_smoke.py``'s inputs, and the builds are timed in
alternating rounds (A B ..., then ... B A) with CUDA events (median of 20
after a spin ahead). The summary goes to ``chiprun_out/gla_probe.json``.

``--clocks`` (with ``--route vec``) also builds ``gla_vec.cu`` with
``-DGLA_CLOCKS`` and prints the SM clocks each warp of block 0 spends in
each phase of a tile (``clock64`` between the phases' ends, a barrier's
wait counted in the phase that ends at it), averaged over the tiles of one
launch at the serving shape.
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

VARIANTS = {
    "ssd": {"shipped": (), "two stages": ("GLA_STAGES=2",)},
    "vec": {"shipped": (), "two blocks per head": ("GLA_VSPLIT=2",),
            "no prefetch": ("GLA_PREFETCH=0",)},
}
OLD = "gla_scan.cu"   # the CUDA-core source, timed beside --route vec


def build_all(source, variants):
    """{variant name: entry points}, compiled in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        name, defs = item
        _, secs, log = kernel.build(source, verbose=True, defines=defs)
        info = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[probe] build {source} {name}: {secs:.1f} s; {info}",
              flush=True)
        return name, kernel.variant(source, defs)

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


PHASES = ("wait for the tile", "cumulative decay", "scaled q and k",
          "diagonal sub-blocks", "sub-block pairs", "barrier: A formed",
          "(q o e^cum) H", "A V and store", "state update")


def phase_clocks(q, k, v, ld, kw):
    """Per-phase SM clocks a tile of the ``-DGLA_CLOCKS`` build, per warp of
    block 0, over one launch."""
    import ctypes
    path = kernel.build("gla_vec", defines=("GLA_CLOCKS",))[0]
    read = ctypes.CDLL(str(path)).gla_vec_clocks
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    kernel._libs["gla_vec"] = kernel.variant("gla_vec", ("GLA_CLOCKS",))
    buf = torch.zeros(len(PHASES), 4, dtype=torch.int64)
    kernel.gla_cuda(q, k, v, ld, **kw)
    torch.cuda.synchronize()
    assert read(buf.data_ptr()) == 0        # zeroes the counters
    kernel.gla_cuda(q, k, v, ld, **kw)
    torch.cuda.synchronize()
    assert read(buf.data_ptr()) == 0
    kernel._libs.pop("gla_vec")
    tiles = -(-q.shape[1] // kernel.MAX_TILE)
    per_tile = (buf.double() / tiles).tolist()
    for name, row in zip(PHASES, per_tile):
        print(f"[probe] clocks a tile, {name:>20}: warps "
              f"{[round(x) for x in row]}", flush=True)
    print(f"[probe] clocks a tile, {'all':>20}: warps "
          f"{[round(sum(r[w] for r in per_tile)) for w in range(4)]}",
          flush=True)
    return dict(zip(PHASES, per_tile))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", choices=sorted(VARIANTS), default="ssd")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gla_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    source = f"gla_{args.route}"
    variants = VARIANTS[args.route]
    libs = build_all(source, variants)
    dev = torch.device("cuda")
    if args.route == "ssd":
        B, S, H, K, V = cs.SERVE_BATCH, cs.SERVE_PROMPT, 112, 64, 64
        q, k, v, ld, u, h0 = cs.gla_inputs(B, S, H, K, V, torch.bfloat16,
                                           "scalar", False, dev, 100)
        kw = dict(chunk=256)
    else:
        B, S, H, K, V = cs.SERVE_BATCH, cs.SERVE_PROMPT, 64, 64, 64
        q, k, v, ld, u, h0 = cs.gla_inputs(B, S, H, K, V, torch.bfloat16,
                                           "rwkv", False, dev, 100)
        kw = dict(bonus=u, strict=True, chunk=64)

    def run_variant(name):
        def run():
            if name == OLD:
                return kernel.run_source("gla_scan", q, k, v, ld, **kw)
            kernel._libs[source] = libs[name]
            return kernel.gla_cuda(q, k, v, ld, **kw)
        return run

    names = list(variants) + ([OLD] if args.route == "vec" else [])
    wo, whT = ref.gla_chunked(q, k, v, ld, **kw)
    o_scale, s_scale = wo.float().abs().max().item(), whT.abs().max().item()
    result = {"card": card, "route": source, "shape": [B, S, H, K, V],
              "variants": {}}
    for name in names:
        o, hT = run_variant(name)()
        torch.cuda.synchronize()
        err = (o.float() - wo.float()).abs()
        excess = (err - cs.GLA_RTOL * o_scale
                  - 2.0 ** -7 * wo.float().abs()).max().item()
        s_err = (hT - whT).abs().max().item()
        if not (excess <= 0.0 and s_err <= cs.GLA_RTOL * s_scale):
            raise AssertionError(f"{name}: disagrees with plain "
                                 f"({err.max().item():.3e}, {s_err:.3e})")
        result["variants"][name] = {
            "defines": list(variants.get(name, ("(the other source)",))),
            "max_abs_err": err.max().item(), "state_err": s_err, "ms": []}
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            result["variants"][name]["ms"].append(
                cs.cuda_ms(run_variant(name), lead=True))
    kernel._libs.pop(source)
    if args.clocks and args.route == "vec":
        result["clocks_a_tile"] = phase_clocks(q, k, v, ld, kw)
    for name, x in result["variants"].items():
        print(f"[probe] {name}: {[round(t, 4) for t in x['ms']]} ms (error "
              f"{x['max_abs_err']:.3e} of max|o| {o_scale:.3e}, state "
              f"{x['state_err']:.3e} of {s_scale:.3e})", flush=True)
    print(f"[probe] {card}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gla_probe.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
