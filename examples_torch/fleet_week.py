"""A week of fleet operation with the randomized controlled experiment
(paper Fig 12): half the cluster-days are shaped, half are control; report
the power drop during peak-carbon hours and the SLO ledger. The PyTorch
counterpart of ``examples/fleet_week.py``; it runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples_torch/fleet_week.py [--days 7]
        [--clusters 16] [--device cuda]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import fleet as F, slo, vcc as V  # noqa: E402


def fig12_cluster_days(n_clusters=16, days=12, seed=5, device=None):
    """Randomized cluster-day treatment: each day a numpy coin
    (``RandomState(0)``) treats a cluster, and only treated clusters run
    under their VCC. Returns the mean normalized power in the top-carbon
    hours of each treated and of each control cluster-day, as two lists."""
    dev = device_mod.resolve(device)
    cfg = F.FleetConfig(n_clusters=n_clusters, n_campuses=4, n_zones=4,
                        lambda_e=0.8, seed=seed)
    st = F.init_fleet(cfg, device=dev)
    rng = np.random.RandomState(0)
    treated_power, control_power = [], []
    for _ in range(days):
        treat_np = rng.rand(n_clusters) < 0.5
        treat = torch.as_tensor(treat_np, device=dev)
        # shape only the treated clusters this day
        power_fn, slope_fn, _ = F.make_power_fn(st)
        fc = F.day_forecasts(st)
        _, _, _, eta_fc = F.carbon_forecast_next(st, st.day)
        prob = F.build_problem(st, fc, eta_fc, power_fn, slope_fn)
        sol = V.solve_vcc(prob, device=dev)
        gate = st.shaping_allowed & sol.shaped & treat
        vcc_curve = torch.where(gate[:, None], sol.vcc,
                                st.capacity[:, None] * 10.0)
        st.hist_tr_pred = torch.cat(
            [st.hist_tr_pred[:, 1:], fc["tr"][:, None]], dim=1)
        st.hist_uif_pred = torch.cat(
            [st.hist_uif_pred[:, 1:], fc["uif"][:, None]], dim=1)
        st, res, intensity = F._observe_day(st, st.day, True, vcc_curve,
                                            collect=True)
        new_slo, allowed = slo.update(st.slo_state, cfg.slo,
                                      res.reservations.sum(1),
                                      vcc_curve.sum(1), res.unmet,
                                      res.arrived)
        st.slo_state, st.shaping_allowed = new_slo, allowed
        p = res.power.cpu().numpy()
        e = intensity.cpu().numpy()
        pn = p / p.mean(axis=1, keepdims=True)        # normalized power
        dirty = e >= np.quantile(e, 0.75, axis=1, keepdims=True)
        for c in range(n_clusters):
            val = pn[c][dirty[c]].mean()
            (treated_power if treat_np[c] else control_power).append(val)
    return treated_power, control_power


def fig12_controlled_experiment(n_clusters=16, days=12, seed=5,
                                device=None):
    """Compare mean normalized power in the top-carbon hours of treated vs
    control cluster-days (``fig12_cluster_days``). Returns ``[(name,
    drop_pct, derived)]``; ``derived`` names both means and their
    counts."""
    treated_power, control_power = fig12_cluster_days(n_clusters, days,
                                                      seed, device)
    t, c = np.mean(treated_power), np.mean(control_power)
    drop_pct = (c - t) / c * 100.0
    return [("fig12_peak_carbon_power_drop_pct", float(drop_pct),
             f"paper: 1-2%; treated={t:.4f} control={c:.4f} "
             f"n=({len(treated_power)},{len(control_power)})")]


def main(argv=None):
    """Print Fig 12's row and a full-shaping week. Returns ``{"fig12":
    rows, "week": [one dict a day], "slo_violation_rate": rate}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=7)
    ap.add_argument("--clusters", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    rows = fig12_controlled_experiment(n_clusters=args.clusters,
                                       days=args.days, device=dev)
    for name, val, derived in rows:
        print(f"{name}: {val:.3f}   ({derived})")
    print("\nfull-shaping week (all clusters treated):")
    cfg = F.FleetConfig(n_clusters=args.clusters, n_campuses=4, n_zones=4,
                        lambda_e=0.6, seed=2)
    st = F.init_fleet(cfg, device=dev)
    week = []
    for d in range(args.days):
        rec = {}
        st = F.day_cycle(st, rec)
        res = rec["result"]
        day = {"day": d,
               "shaped": int((rec["sol"].shaped & st.shaping_allowed).sum()),
               "served": float(res.served.sum()),
               "carbon": float(res.carbon.sum()),
               "queue": float(st.queue.sum())}
        week.append(day)
        print(f"  day {d}: shaped={day['shaped']}/{args.clusters} "
              f"served={day['served']:.0f} "
              f"carbon={day['carbon']:.0f} kgCO2e "
              f"queue={day['queue']:.0f}")
    rate = float(slo.violation_rate(st.slo_state).float().mean())
    print(f"SLO violation rate: {rate:.3f} (target <= 0.03 in steady "
          "state; early operation is noisier)")
    return {"fig12": rows, "week": week, "slo_violation_rate": rate}


if __name__ == "__main__":
    main()
