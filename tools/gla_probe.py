#!/usr/bin/env python3
"""Time the layout variants of kernel #5's tensor-core routes on one card.

    python3 tools/gla_probe.py [--route ssd|vec|scan] [OLD_DIR] [--rounds 2]
                               [--clocks]

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
split-TF32 source ``gla_scan.cu`` at RWKV6-7B's serving prefill (4 x 1,024
tokens, 64 heads, K = V = 64, per-channel decay, bonus, strict).

Every build goes into ``build/`` (in parallel, ptxas registers and spills
printed), is checked against the plain version at ``chip_smoke.py``'s
limit on ``chip_smoke.py``'s inputs, and the builds are timed in
alternating rounds (A B ..., then ... B A) with CUDA events (median of 20
after a spin ahead). The summary goes to ``chiprun_out/gla_probe.json``
(``gla_probe_vec.json``, ``gla_probe_scan.json``).

``--route scan`` builds the split-TF32 source ``csrc/gla_scan.cu`` as
shipped (four warps per 16 value columns: 16 warps a block at V = 64) and
with ``-DGLA_VSPLIT=2`` and ``=4`` (the value columns split over two and
four blocks per (batch, head), each forming A again), and, given ``OLD_DIR`` (a directory holding an earlier
``gla_scan.cu``, e.g. the parent commit's CUDA-core kernel), that source
too, and times them at every case of ``chip_smoke.py``'s ``gla_cases``
that goes to ``gla_scan`` (on its inputs), beside the FP32 bound and the
split-TF32 ceiling. A build whose entry point refuses a case (a split of
the value columns that does not divide its 16-column warps) is reported as
refused.

``--also DIR`` (with ``--route scan``, repeatable) times the
``gla_scan.cu`` in DIR too, built as it stands (a source with the shipped
entry point's arguments: an earlier version of the redesign).

``--clocks`` (with ``--route vec`` or ``scan``) also builds the route's
source with ``-DGLA_CLOCKS`` and prints the SM clocks each warp of block 0
spends in each phase of a tile (``clock64`` between the phases' ends, a
barrier's wait counted in the phase that ends at it), averaged over the
tiles of one launch at each case.
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
    "scan": {"shipped": (), "two blocks per head": ("GLA_VSPLIT=2",),
             "four blocks per head": ("GLA_VSPLIT=4",)},
}
OLD = "gla_scan.cu"   # the split-TF32 source, timed beside --route vec
PARENT = "earlier gla_scan.cu"   # OLD_DIR's source, with --route scan


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


# the phases of a tile that -DGLA_CLOCKS times, and the warps it keeps
PHASES = {
    "vec": (("wait for the tile", "cumulative decay", "scaled q and k",
             "diagonal sub-blocks", "sub-block pairs", "barrier: A formed",
             "(q o e^cum) H", "A V and store", "state update"), 4),
    "scan": (("wait for the tile", "H^T out, cum. decay", "scaled q and k",
              "A", "barrier: A formed", "next tile's loads",
              "(q o e^cum) H", "A V and store", "state update"), 16),
}


def phase_clocks(route, q, k, v, ld, kw):
    """Per-phase SM clocks a tile of the ``-DGLA_CLOCKS`` build, per warp of
    block 0, over one launch."""
    import ctypes
    source = f"gla_{route}"
    names, width = PHASES[route]
    path = kernel.build(source, defines=("GLA_CLOCKS",))[0]
    read = getattr(ctypes.CDLL(str(path)), f"{source}_clocks")
    read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
    kernel._libs[source] = kernel.variant(source, ("GLA_CLOCKS",))
    buf = torch.zeros(len(names), width, dtype=torch.int64)
    kernel.gla_cuda(q, k, v, ld, **kw)
    torch.cuda.synchronize()
    assert read(buf.data_ptr()) == 0        # zeroes the counters
    kernel.gla_cuda(q, k, v, ld, **kw)
    torch.cuda.synchronize()
    assert read(buf.data_ptr()) == 0
    kernel._libs.pop(source)
    tiles = -(-q.shape[1] // kernel.MAX_TILE)
    used = [w for w in range(width) if buf[:, w].any()]
    per_tile = (buf[:, used].double() / tiles).tolist()
    for name, row in zip(names, per_tile):
        print(f"[probe] clocks a tile, {name:>20}: warps "
              f"{[round(x) for x in row]}", flush=True)
    print(f"[probe] clocks a tile, {'all':>20}: warps "
          f"{[round(sum(r[w] for r in per_tile)) for w in range(len(used))]}",
          flush=True)
    return dict(zip(names, per_tile))


def cases(route):
    """(label, inputs, options) of the probe's cases: Zamba2-7B's Mamba2
    prefill (ssd), RWKV6-7B's serving prefill (vec), or every case of
    ``chip_smoke.py``'s ``gla_cases`` on ``gla_scan`` (scan), on that
    script's inputs."""
    dev = torch.device("cuda")
    if route == "ssd":
        B, S, H, K, V = cs.SERVE_BATCH, cs.SERVE_PROMPT, 112, 64, 64
        return [("zamba2 mamba2 prefill", cs.gla_inputs(
            B, S, H, K, V, torch.bfloat16, "scalar", False, dev, 100),
            dict(chunk=256))]
    if route == "vec":
        B, S, H, K, V = cs.SERVE_BATCH, cs.SERVE_PROMPT, 64, 64, 64
        q, k, v, ld, u, h0 = cs.gla_inputs(B, S, H, K, V, torch.bfloat16,
                                           "rwkv", False, dev, 100)
        return [(cs.RWKV_SERVE_CASE, (q, k, v, ld, u, h0),
                 dict(bonus=u, strict=True, chunk=64))]
    out = []
    for i, (label, B, S, H, K, V, dt, mode, chunk, init) in enumerate(
            cs.gla_cases()):
        vec, bonus, strict = cs.gla_mode(mode)
        if kernel.route(dt, K, V, vec=vec, bonus=bonus,
                        strict=strict) != "gla_scan":
            continue
        x = cs.gla_inputs(B, S, H, K, V, dt, mode, init, dev, 100 + i)
        out.append((label, x, dict(bonus=x[4], strict=strict, chunk=chunk,
                                   initial_state=x[5])))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", choices=sorted(VARIANTS), default="ssd")
    ap.add_argument("old_dir", nargs="?", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--also", action="append", default=[], metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gla_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    props = torch.cuda.get_device_properties(0)
    rates = cs.Card(props.multi_processor_count,
                    float(cs.smi("clocks.max.sm").split()[0]))
    source = f"gla_{args.route}"
    variants = VARIANTS[args.route]
    libs = build_all(source, variants)
    parent = None
    if args.route == "scan" and args.old_dir:
        parent = cs.load_parent_scan(args.old_dir)
    from repro_torch.kernels import nvcc
    for d in args.also:
        libs[f"also {d}"] = nvcc.load(
            nvcc.build(Path(d) / "gla_scan.cu")[0], *kernel._ENTRY[source])
    names = list(variants) + [f"also {d}" for d in args.also] + (
        [OLD] if args.route == "vec" else []) + (
        [PARENT] if parent is not None else [])
    result = {"card": card, "route": source, "cases": {}}
    for label, (q, k, v, ld, u, h0), kw in cases(args.route):
        def run_variant(name):
            def run():
                if name == OLD:
                    return kernel.run_source("gla_scan", q, k, v, ld, **kw)
                if name == PARENT:
                    return cs.run_parent_scan(parent, q, k, v, ld, **kw)
                kernel._libs[source] = libs[name]
                return kernel.gla_cuda(q, k, v, ld, **kw)
            return run

        wo, whT = ref.gla_chunked(q, k, v, ld, **kw)
        o_scale, s_scale = wo.float().abs().max().item(), \
            whT.abs().max().item()
        ulp = 0.0 if q.dtype == torch.float32 else 2.0 ** -7
        row = {"shape": [*q.shape, v.shape[-1]], "variants": {},
               "refused": []}
        for name in list(names):
            try:
                o, hT = run_variant(name)()
            except RuntimeError as e:
                if "launch failed" not in str(e):
                    raise
                row["refused"].append(name)
                continue
            torch.cuda.synchronize()
            err = (o.float() - wo.float()).abs()
            excess = (err - cs.GLA_RTOL * o_scale
                      - ulp * wo.float().abs()).max().item()
            s_err = (hT - whT).abs().max().item()
            if not (excess <= 0.0 and s_err <= cs.GLA_RTOL * s_scale):
                raise AssertionError(f"{label}, {name}: disagrees with "
                                     f"plain ({err.max().item():.3e}, "
                                     f"{s_err:.3e})")
            row["variants"][name] = {
                "defines": list(variants.get(name, ("(another source)",))),
                "max_abs_err": err.max().item(), "state_err": s_err,
                "ms": []}
        timed = [n for n in names if n not in row["refused"]]
        for r in range(args.rounds):
            for name in (timed if r % 2 == 0 else timed[::-1]):
                row["variants"][name]["ms"].append(
                    cs.cuda_ms(run_variant(name), lead=True))
        kernel._libs.pop(source)
        B, S, H, K = q.shape
        flops = kernel.gla_flops(B, S, H, K, v.shape[-1],
                                 vec=ld.dim() == 4, bonus=u is not None,
                                 strict=kw.get("strict", False),
                                 chunk=kw["chunk"])
        nbytes = kernel.gla_bytes(q, k, v, ld, bonus=u,
                                  initial_state=kw.get("initial_state"))
        bound_ms, by, _, bytes_ms = rates.bound(flops, nbytes, q.dtype)
        row["bound_ms"], row["bound_by"] = bound_ms, by
        row["ceiling_ms"] = max(bytes_ms,
                                1e3 * 3 * flops / cs.TF32_TENSOR_PER_S)
        if args.route == "scan":
            row["plain_ms"] = cs.cuda_ms(
                lambda: ref.gla_chunked(q, k, v, ld, **kw), reps=5,
                warmup=1)
        result["cases"][label] = row
        for name, x in row["variants"].items():
            print(f"[probe] {label}, {name}: "
                  f"{[round(t, 4) for t in x['ms']]} ms (error "
                  f"{x['max_abs_err']:.3e} of max|o| {o_scale:.3e}, state "
                  f"{x['state_err']:.3e} of {s_scale:.3e})", flush=True)
        if row["refused"]:
            print(f"[probe] {label}: refused by {row['refused']}", flush=True)
        print(f"[probe] {label}: bound {bound_ms:.4f} ms by {by}, split-TF32 "
              f"ceiling {row['ceiling_ms']:.4f} ms"
              + (f", plain {row['plain_ms']:.4f} ms" if "plain_ms" in row
                 else ""), flush=True)
        if args.clocks and args.route in PHASES:
            print(f"[probe] {label}: clocks of the shipped source", flush=True)
            row["clocks_a_tile"] = phase_clocks(args.route, q, k, v, ld, kw)
        del q, k, v, ld, wo, whT
    print(f"[probe] {card}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"gla_probe{'' if args.route == 'ssd' else '_' + args.route}"
     ".json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
