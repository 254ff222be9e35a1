"""Quickstart: one CICS day on a small synthetic fleet.

Shows the paper's full pipeline end-to-end — carbon forecast, power-model
fit, load forecasts, risk-aware VCC optimization, Borg-like admission — and
prints the cluster-level result: VCC dips where carbon peaks, flexible work
shifts to green hours, daily totals conserved. The PyTorch counterpart of
``examples/quickstart.py``; it runs on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cuda]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import fleet as F  # noqa: E402


def main(argv=None):
    """Print the first shaped cluster's hourly table and its day's totals.
    Returns ``{"shaped", "cluster", "hours": [(h, carbon, vcc, flex,
    inflex)], "corr", "served", "arrived"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    print("== CICS quickstart: init fleet (incl. 91-day telemetry burn-in)")
    cfg = F.FleetConfig(n_clusters=8, n_campuses=2, n_zones=2, lambda_e=0.6,
                        seed=0)
    st = F.init_fleet(cfg, device=dev)
    rec = {}
    st = F.day_cycle(st, rec)
    sol, res, eta = rec["sol"], rec["result"], rec["intensity"]
    shaped = (sol.shaped & st.shaping_allowed).cpu().numpy()
    print(f"shaped clusters: {shaped.sum()}/{cfg.n_clusters}")
    c = int(np.nonzero(shaped)[0][0])
    print(f"\ncluster {c} — hourly view (paper Fig 3):")
    print(f"{'h':>3} {'carbon':>7} {'VCC':>7} {'flex':>6} {'inflex':>7}")
    eta_c = eta[c].cpu().numpy()
    vcc = rec["vcc"][c].cpu().numpy()
    flex = res.usage_flex[c].cpu().numpy()
    uif = (res.usage_total[c] - res.usage_flex[c]).cpu().numpy()
    hours = []
    for h in range(24):
        bar = "#" * int(eta_c[h] * 40)
        hours.append((h, float(eta_c[h]), float(vcc[h]), float(flex[h]),
                      float(uif[h])))
        print(f"{h:3d} {eta_c[h]:7.3f} {vcc[h]:7.2f} "
              f"{flex[h]:6.2f} {uif[h]:7.2f}  {bar}")
    corr = float(np.corrcoef(sol.delta[c].cpu().numpy(), eta_c)[0, 1])
    print(f"\ncorr(delta, carbon) = {corr:.2f}  (negative = load shifted "
          "away from dirty hours)")
    served, arrived = float(res.served[c]), float(res.arrived[c])
    print(f"flexible served / arrived: {served:.1f} / "
          f"{arrived:.1f} CPU-h (daily total conserved)")
    return {"shaped": int(shaped.sum()), "cluster": c, "hours": hours,
            "corr": corr, "served": served, "arrived": arrived}


if __name__ == "__main__":
    main()
