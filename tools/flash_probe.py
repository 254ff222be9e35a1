#!/usr/bin/env python3
"""Time kernel #4's design choices on one CUDA card.

    python3 tools/flash_probe.py [--rounds 2]

Builds the flash-attention sources of ``kernels/flash_attention/csrc`` as
they are and in variants with one constant changed (into ``build/probe/``),
then, at the serving path's shapes of ``chip_smoke.py`` (Zamba2-7B and
Qwen3-0.6B, prefill of 4 x 1,024 tokens and a decode call over a 1,064-slot
cache filled to 1,041), times each build in alternating rounds (A B ...,
then ... B A) with CUDA events (median of 20 after a spin ahead) and checks
it against ``ref.attention_reference`` (2e-2 in bf16, 2e-5 in float32):

* decode: the split kernel's keys a lane group takes a step (``U``) and
  ring stages (``S``); and, for the source as it is, the time over 1 to 32
  key splits, with the split kernel alone and with the combine;
* bf16 prefill: 32 or 64 keys a tile at a padded width of 128.

    python3 tools/flash_probe.py --f32 [OLD_DIR] [--rounds 2]

times the float32 prefill route (``flash_attention.cu``) instead, at every
float32 prefill case of ``chip_smoke.py`` (``flash_cases`` and
train_carbon_aware's call): the source as it is, its variants in
``F32_VARIANTS``, and, given ``OLD_DIR`` (a directory holding an earlier
``flash_attention.cu`` and its ``flash_common.cuh``, e.g. unpacked from the
parent commit), that source too, in the same alternating rounds; each with
its error against ``ref.attention_reference`` (limit 2e-5), beside SDPA's
time, the FP32 bound and the split-TF32 ceiling. A build whose entry point
refuses a case (the first port's kernel took B * N < 65,536) is reported
as refused.

Each build's ptxas registers are printed. The summary goes to
``chiprun_out/flash_probe.json`` (``flash_probe_f32.json`` with ``--f32``).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ref  # noqa: E402

# name: (source, [(text, replacement), ...]); the first of each source is
# the source as it is
VARIANTS = {
    "decode": ("flash_decode", []),
    "decode U=1 S=8": ("flash_decode", [
        ("constexpr int U = 2;", "constexpr int U = 1;"),
        ("constexpr int S = 4;", "constexpr int S = 8;")]),
    "decode U=4": ("flash_decode", [
        ("constexpr int U = 2;", "constexpr int U = 4;")]),
    "decode S=3": ("flash_decode", [
        ("constexpr int S = 4;", "constexpr int S = 3;")]),
    "decode S=6": ("flash_decode", [
        ("constexpr int S = 4;", "constexpr int S = 6;")]),
    "prefill": ("flash_prefill", []),
    "prefill BN=64 at HP=128": ("flash_prefill", [
        ("run<128, 32>(a, vec, st)", "run<128, 64>(a, vec, st)")]),
}
SPLITS = (1, 2, 3, 5, 8, 16, 32)
# the float32 prefill route's variants, as VARIANTS: its source as it is,
# 32 keys a tile at HMAX = 192 (one block an SM), 64 at HMAX = 64, and P V's
# groups of output tiles at HMAX = 192 and 256 at 3 and 4 (2 in the source)
F32 = "flash_attention"
DG = "constexpr int DG = DW <= 4 ? DW : 2;"
F32_VARIANTS = {
    "f32": (F32, []),
    "f32 BN=32 at HMAX=192": (F32, [("run<192, 16>(a, vec, st)",
                                     "run<192, 32>(a, vec, st)")]),
    "f32 BN=64 at HMAX=64": (F32, [("run<64, 32>(a, vec, st)",
                                    "run<64, 64>(a, vec, st)")]),
    "f32 DG 3 / 4": (F32, [(DG, DG.replace(": 2;", ": DW / 2;"))]),
}


def build_variants(variants, old_dir=None):
    """Library path of every variant (sources patched into build/probe/,
    compiled in parallel); with ``old_dir``, its ``flash_attention.cu`` too,
    as the variant "f32 old"."""
    from concurrent.futures import ThreadPoolExecutor
    out = nvcc.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    items = [(name, kernel.SOURCES[src], patches)
             for name, (src, patches) in variants.items()]
    if old_dir is not None:
        items.append(("f32 old", Path(old_dir) / "flash_attention.cu", []))

    def one(item):
        name, source, patches = item
        text = source.read_text()
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {source.name}")
            text = text.replace(old, new)
        path = out / (re.sub(r"[^A-Za-z0-9]+", "_", name) + ".cu")
        path.write_text(text)
        lib, _, log = nvcc.build(path, (source.parent / "flash_common.cuh",),
                                 nvcc.FLAGS + ("-I", str(source.parent)),
                                 verbose=True)
        regs = [line.split(" : ", 1)[-1] for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"[probe] {name}: ptxas {regs}", flush=True)
        return name, lib

    with ThreadPoolExecutor(len(items)) as pool:
        return dict(pool.map(one, items))


def cases():
    B, P, M, pos = cs.SERVE_BATCH, cs.SERVE_PROMPT, cs.SERVE_MAX_SEQ, \
        cs.DECODE_POS
    dec = dict(causal=True, q_offset=pos, length=pos + 1)
    bf = torch.bfloat16
    return [("zamba2 decode", B, 1, M, 32, 32, 112, bf, dec),
            ("qwen3 decode", B, 1, M, 16, 8, 128, bf, dec),
            ("zamba2 decode float32", B, 1, M, 32, 32, 112, torch.float32,
             dec),
            ("zamba2 prefill", B, P, P, 32, 32, 112, bf, dict(causal=True)),
            ("qwen3 prefill", B, P, P, 16, 8, 128, bf, dict(causal=True))]


def f32_cases():
    """Every float32 call of ``chip_smoke.py`` on the float32 prefill
    route."""
    return [c for c in cs.flash_cases() + [cs.EX_TRAIN_CASE]
            if kernel.route(c[2], c[7]) == F32]


def main_f32(card, old_dir, rounds):
    rates = cs.Card(*cs.phase_device()[1:])    # TF32 off for the reference
    libs = {name: nvcc.load(path, *kernel._ENTRY[F32])
            for name, path in build_variants(F32_VARIANTS, old_dir).items()}
    names = list(libs)
    dev = torch.device("cuda")
    result = {"card": card, "cases": {}}
    for label, B, Sq, Sk, N, K, H, dt, mask in f32_cases():
        g = torch.Generator(device=dev).manual_seed(Sq + Sk + H)
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
                   for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H)))
        if label in cs.MLA_V_DIM:
            v[..., cs.MLA_V_DIM[label]:] = 0
        want = ref.attention_reference(q, k, v, **mask)
        row = {}

        def run():
            return kernel.flash_attention_cuda(q, k, v, **mask)

        for n in names:
            kernel._libs[F32] = libs[n]
            try:
                err = (run() - want).abs().max().item()
            except RuntimeError as e:
                row[n] = {"refused": str(e)}
                continue
            if not err <= cs.FLASH_TOL[dt]:
                raise AssertionError(f"{label}, {n}: error {err:.3e}")
            row[n] = {"max_abs_err": err, "ms": []}
        timed = [n for n in names if "ms" in row[n]]
        for r in range(rounds):
            for n in (timed if r % 2 == 0 else timed[::-1]):
                kernel._libs[F32] = libs[n]
                row[n]["ms"].append(cs.cuda_ms(run, lead=True))
        lib_name, lib = cs.library_call(q, k, v, mask)
        pairs = {x: y for x, y in mask.items() if x != "softcap"}
        flops = kernel.attention_flops(B, Sq, Sk, N, H, **pairs)
        nbytes = kernel.attention_bytes(B, Sq, Sk, N, K, H, 4, **pairs)
        row["library"], row["library_ms"] = lib_name, cs.cuda_ms(
            lib, lead=True)
        row["fp32_bound_ms"], _, _, bytes_ms = rates.bound(flops, nbytes)
        row["split_tf32_ceiling_ms"] = max(
            bytes_ms, 1e3 * 3 * flops / cs.TF32_TENSOR_PER_S)
        result["cases"][label] = row
        print(f"[probe] {label} (B={B} Sq={Sq} Sk={Sk} N={N} K={K} H={H} "
              f"{mask}): " + "; ".join(
                  f"{n} refused" if "refused" in row[n] else
                  f"{n} {row[n]['ms']} ms (error "
                  f"{row[n]['max_abs_err']:.3e})" for n in names)
              + f"; {lib_name} {row['library_ms']} ms; FP32 bound "
              f"{row['fp32_bound_ms']:.4f} ms, split-TF32 ceiling "
              f"{row['split_tf32_ceiling_ms']:.4f} ms", flush=True)
        del q, k, v, want
    kernel._libs.clear()
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--f32", nargs="?", const="", metavar="OLD_DIR",
                    default=None)
    args = ap.parse_args()
    rounds = args.rounds
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    if args.f32 is not None:
        result = main_f32(card, args.f32 or None, rounds)
        print(f"[probe] {card}")
        (out / "flash_probe_f32.json").write_text(
            json.dumps(result, indent=1))
        return
    libs = {name: nvcc.load(path, *kernel._ENTRY[VARIANTS[name][0]])
            for name, path in build_variants(VARIANTS).items()}
    dev = torch.device("cuda")
    result = {"card": card, "cases": {}}
    for label, B, Sq, Sk, N, K, H, dt, mask in cases():
        g = torch.Generator(device=dev).manual_seed(Sq + Sk + H)
        q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
                   for s in ((B, Sq, N, H), (B, Sk, K, H), (B, Sk, K, H)))
        want = ref.attention_reference(q, k, v, **mask)
        src = kernel.route(Sq, dt)
        names = [n for n in VARIANTS if VARIANTS[n][0] == src]
        tol = cs.FLASH_TOL[dt]
        row = {n: {"ms": []} for n in names}

        def run():
            return kernel.flash_attention_cuda(q, k, v, **mask)

        for n in names:
            kernel._libs[src] = libs[n]
            err = (run().float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{label}, {n}: error {err:.3e}")
            row[n]["max_abs_err"] = err
        for r in range(rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                kernel._libs[src] = libs[n]
                row[n]["ms"].append(cs.cuda_ms(run, lead=True))
        kernel._libs[src] = libs[names[0]]
        if src == "flash_decode":
            shape, strides, kv_len = kernel._checked(q, k, v,
                                                     mask["length"], None)
            margs = kernel._mask_args(True, None, mask["q_offset"], kv_len)
            out = torch.empty_like(q)
            sweep = {}
            for sp in SPLITS:
                def part(combine, sp=sp):
                    return kernel._decode(q, k, v, out, sp, combine, shape,
                                          strides, margs,
                                          kernel._scale(H, None), None)
                sweep[sp] = {"with_combine_ms": cs.cuda_ms(
                    lambda: part(True), lead=True),
                    "split_only_ms": cs.cuda_ms(lambda: part(False),
                                                lead=True)}
            row["splits_sweep"] = sweep
            begin, end = ref.key_span(Sq, Sk, **mask)
            row["splits_chosen"] = kernel.decode_splits(
                B, K, N // K * Sq, end - begin,
                torch.cuda.get_device_properties(0).multi_processor_count)
        result["cases"][label] = row
        print(f"[probe] {label}: " + "; ".join(
            f"{n} {x['ms']} ms (error {x['max_abs_err']:.3e})"
            for n, x in row.items() if n in VARIANTS), flush=True)
        if "splits_sweep" in row:
            print(f"[probe] {label}: chosen {row['splits_chosen']} splits; "
                  "ms with the combine / split kernel alone by splits: "
                  + ", ".join(f"{sp}: {x['with_combine_ms']:.4f} / "
                              f"{x['split_only_ms']:.4f}"
                              for sp, x in row["splits_sweep"].items()),
                  flush=True)
        del q, k, v, want
    kernel._libs.clear()
    print(f"[probe] {card}")
    (out / "flash_probe.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
