"""Scenario engine + batched fleet simulation, PyTorch port: the scenario
libraries (``scenarios``), the batched rollout engine over a
(scenario x seed) axis (``engine``), the emissions ledger with its unshaped
counterfactual (``ledger``) and per-scenario reporting (``report``)."""
from repro_torch.sim.engine import (SimConfig, SimParams, SimState,  # noqa
                                    make_day_step, make_init, make_rollout,
                                    rollout_batch, rollout_sequential)
from repro_torch.sim.ledger import (Ledger, init_ledger,  # noqa: F401
                                    ledger_update, summarize)
from repro_torch.sim.report import (MOBILITY_COLUMNS,  # noqa: F401
                                    MPC_COLUMNS, RISK_COLUMNS, format_table,
                                    mobility_sweep_rows, mpc_recourse_rows,
                                    risk_sweep_rows, scenario_rows,
                                    state_nbytes)
from repro_torch.sim.scenarios import (MOBILITY_SWEEP,  # noqa: F401
                                       RISK_BETAS, RISK_MEMBERS,
                                       Scenario,
                                       build_batch, build_params,
                                       default_library,
                                       forecast_bust_library,
                                       mobility_sweep_library,
                                       risk_sweep_library)
