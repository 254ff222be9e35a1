#!/usr/bin/env python3
"""The first train steps of one-layer models at published width on one card.

    python3 tools/lr_probe.py

``chip_smoke.py`` trains DeepSeek-V2-236B at 1 of its 60 layers (its dense
first layer with its MLA mixer) with the reference trainer's settings
(batch 8, sequence 256, peak lr 3e-3, warmup 20); its loss rises in the
second step. This script runs 4 steps of ``launch.train.train`` on that
model in bf16 and in float32 at lr 3e-3 (whether the rise comes from
bf16's rounding or from the kernel routes), in bf16 at 3e-4 and 3e-5 (the
learning rate), and Qwen3-0.6B and DeepSeekMoE-16B cut to one layer at
3e-3 (the width), each from seed 0, and prints each run's losses and the
card's name and power limit.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    cs.phase_device()
    cs.phase_build()
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    runs = [("deepseek-v2-236b", dtype, lr) for dtype, lr in (
        ("bfloat16", 3e-3), ("float32", 3e-3), ("bfloat16", 3e-4),
        ("bfloat16", 3e-5))]
    runs += [(arch, "bfloat16", 3e-3)
             for arch in ("qwen3-0.6b", "deepseek-moe-16b")]
    for arch, dtype, lr in runs:
        cfg = get_arch(arch).config.replace(num_layers=1, remat="none",
                                            dtype=dtype)
        model = build_model(cfg, "cuda", seed=0)
        res = train(model=model, steps=4, batch=8, seq=256, lr=lr,
                    device="cuda", log_every=100)
        print(f"[lr] {arch} 1 layer {dtype} lr {lr}: losses "
              f"{[round(x, 4) for x in res.step_losses]}", flush=True)
        del model
        torch.cuda.empty_cache()
    print(cs.smi("name,power.limit"), flush=True)


if __name__ == "__main__":
    main()
