"""End-to-end example: train a ~100M-parameter qwen3-family model for a few
hundred steps under carbon-aware (VCC-gated) step pacing, with
checkpoint/restart.

The trainer is the canonical *flexible workload* of the paper: its hourly
step budget follows a single-cluster VCC derived from simulated grid carbon
intensity; the daily step budget is conserved (time-shifted, not reduced).
The PyTorch counterpart of ``examples/train_carbon_aware.py``; it runs on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples_torch/train_carbon_aware.py [--steps 300]
        [--device cuda]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs as C, device as device_mod  # noqa: E402
from repro_torch.launch import train as trainmod  # noqa: E402
from repro_torch.models import param_count  # noqa: E402


def config_100m():
    """~100M config: qwen3 family scaled (12 layers, d=512, vocab 32k),
    float32."""
    arch = C.get_arch("qwen3-0.6b")
    return arch.config.replace(
        name="qwen3-100m", num_layers=12, d_model=512, d_ff=1536,
        vocab_size=32768, dtype="float32", remat="none",
        attn=arch.config.attn.__class__(num_heads=8, num_kv_heads=4,
                                        head_dim=64, qk_norm=True,
                                        rope_theta=1e6))


def main(argv=None):
    """Train the ~100M config through ``launch.train.main``. Returns the
    losses it logged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128,
                    help="CPU demo default; a real run uses >=1024")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_carbon_train")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)

    cfg = config_100m()
    n = param_count(cfg)
    print(f"model: {cfg.name}, {n/1e6:.1f}M params")

    # reuse the production trainer loop with this config via its CLI; it
    # logs a loss every 10 steps (the trainer's default), or often enough
    # for a short run to log three
    log_every = min(10, max(1, args.steps // 3))
    argv = ["--arch", "qwen3-0.6b", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--carbon-aware", "--ckpt-dir", args.ckpt_dir,
            "--steps-per-hour", "25", "--lr", "3e-3", "--smoke",
            "--log-every", str(log_every), "--device", args.device]
    # swap in the 100M config by patching the name the trainer looks up
    arch100 = C.base.Arch(config=cfg, smoke=cfg)
    orig = trainmod.get_arch

    def patched(name):
        return arch100 if name == "qwen3-0.6b" else orig(name)

    trainmod.get_arch = patched
    try:
        losses = trainmod.main(argv)
    finally:
        trainmod.get_arch = orig
    print(f"loss trajectory: {losses[:3]} ... {losses[-3:]}")
    if not losses[-1] < losses[0]:
        raise AssertionError("training must improve")
    print("done — resume by re-running (checkpoints in "
          f"{args.ckpt_dir})")
    return losses


if __name__ == "__main__":
    main()
