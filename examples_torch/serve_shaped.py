"""Carbon-aware batched serving: flexible batch-inference requests are
admitted under a VCC-derived gate while the model decodes with a KV cache.
The PyTorch counterpart of ``examples/serve_shaped.py``; it runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples_torch/serve_shaped.py [--device cuda]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402

ARGV = ["--arch", "qwen3-0.6b", "--smoke", "--batch", "4",
        "--prompt-len", "24", "--gen", "16", "--rounds", "4",
        "--carbon-aware"]


def main(argv=None):
    """``launch.serve.main`` with the original's arguments on
    ``--device``. Returns its ``ServeResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return serve.main(ARGV + ["--device", args.device])


if __name__ == "__main__":
    main()
