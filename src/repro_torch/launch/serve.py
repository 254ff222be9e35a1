"""Batched serving loop: prefill and greedy decode with a KV cache, with
optional carbon-aware admission of request batches. The counterpart of
``repro.launch.serve``.

With ``--carbon-aware``, round r admits ``batch * min(capacity[r % 24],
1.5)`` requests (at least one), where ``capacity`` is the hourly capacity
of a one-cluster VCC (``launch.train.CarbonGate``, as the reference
imports it from its trainer): flexible batch inference shifts
toward clean hours; latency-critical serving is never gated.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --device cpu --carbon-aware

A VLM's prompts come with zero ``vision_embeds`` and an encoder-decoder's
with zero ``frames`` (``models.stub_inputs``, the reference's stub
frontends); a VLM decodes from position vision_tokens + prompt_len. Its
cache holds vision_tokens + prompt_len + gen + 8 positions: the
reference's loop sizes it prompt_len + gen + 8 and so cannot serve
InternVL2-2B's 256 vision tokens (ROADMAP.md §3).

Runs on ``cuda`` unless ``--device cpu`` is given (and raises without a
card). ``serve(...)`` is the same loop as a function: it returns the
tokens, the admitted batch sizes and the timings.
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import get_arch
from repro_torch.launch.train import CarbonGate
from repro_torch.models import build_model
from repro_torch.models.model import prompt_start, stub_inputs
from repro_torch.training import make_prefill_step, make_serve_step


class ServeResult(NamedTuple):
    tokens: List[torch.Tensor]    # per round: (batch, gen + 1) on the CPU
    batches: List[int]            # admitted batch size per round
    prefill_ms: List[float]       # per round
    decode_ms: List[float]        # per round: milliseconds a decoded token
    seconds: float                # all rounds, wall clock
    tokens_per_s: float
    # per round, with keep_logits: [prefill, each decode step] (batch,
    # vocab) float32 on the CPU
    logits: Optional[List[List[torch.Tensor]]]


def serve(arch: str = "qwen3-0.6b", *, smoke: bool = False, batch: int = 4,
          prompt_len: int = 32, gen: int = 32, rounds: int = 3,
          carbon_aware: bool = False, device=None, seed: int = 0,
          model=None,
          keep_logits: bool = False, verbose: bool = True) -> ServeResult:
    """Serve ``rounds`` batches of random prompts (``np.random.RandomState
    (seed)``, as the reference draws them) with greedy decoding. ``model``
    (already on ``device``) replaces the one built from ``arch`` with
    weights from ``seed``."""
    dev = device_mod.resolve(device)
    a = get_arch(arch)
    cfg = (a.smoke if smoke else a.config).replace(remat="none")
    if model is None:
        model = build_model(cfg, dev, seed=seed)
    cfg = model.cfg
    start = prompt_start(cfg)
    max_seq = start + prompt_len + gen + 8
    prefill = make_prefill_step(model, max_seq)
    decode = make_serve_step(model)
    gate = CarbonGate() if carbon_aware else None
    rng = np.random.RandomState(seed)
    cuda = dev.type == "cuda"

    def now():
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    tokens, batches, pre_ms, dec_ms, all_logits = [], [], [], [], []
    total = 0
    t_start = now()
    for r in range(rounds):
        if gate is not None:
            bsz = gate.admitted(r, batch)
            if verbose:
                print(f"[serve] round {r}: hour={r % 24} carbon="
                      f"{gate.intensity[r % 24]:.3f} admitted batch={bsz}")
        else:
            bsz = batch
        toks = rng.randint(1, cfg.vocab_size, size=(bsz, prompt_len))
        inputs = {"tokens": torch.tensor(toks, dtype=torch.int64,
                                         device=dev),
                  **stub_inputs(cfg, bsz, dev)}
        t0 = now()
        logits, cache = prefill(inputs)
        tok = torch.argmax(logits, -1)
        t1 = now()
        out, kept = [tok], [logits]
        for i in range(gen):
            logits, cache = decode(cache, tok, start + prompt_len + i)
            tok = torch.argmax(logits, -1)
            out.append(tok)
            kept.append(logits)
        t2 = now()
        del cache
        pre_ms.append(1e3 * (t1 - t0))
        dec_ms.append(1e3 * (t2 - t1) / max(gen, 1))
        batches.append(bsz)
        tokens.append(torch.stack(out, 1).cpu())
        if keep_logits:
            all_logits.append([x.float().cpu() for x in kept])
        total += bsz * (gen + 1)
        if verbose:
            print(f"[serve] round {r}: generated {gen} toks/seq; prefill "
                  f"{pre_ms[-1]:.1f} ms, decode {dec_ms[-1]:.2f} ms/token; "
                  f"sample: {tokens[-1][0][:12].tolist()}")
    secs = now() - t_start
    if verbose:
        print(f"[serve] {total} tokens in {secs:.1f}s "
              f"({total / secs:.1f} tok/s) on {dev}")
    return ServeResult(tokens, batches, pre_ms, dec_ms, secs, total / secs,
                       all_logits if keep_logits else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--carbon-aware", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)
    return serve(args.arch, smoke=args.smoke, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen,
                 rounds=args.rounds, carbon_aware=args.carbon_aware,
                 device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
