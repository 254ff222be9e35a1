"""Scenario engine + batched fleet simulation, PyTorch port: the scenario
libraries (``scenarios``), the batched rollout engine over a
(scenario x seed) axis (``engine``), the emissions ledger with its unshaped
counterfactual (``ledger``), per-scenario reporting (``report``) and the
telemetry layer (``telemetry``: the day's diagnostics record and the
span-based stage table of ``repro_torch.spans``)."""
from repro_torch.sim.engine import (SimConfig, SimParams, SimState,
                                    make_day_step, make_init, make_rollout,
                                    rollout_batch, rollout_batch_sharded,
                                    rollout_sequential)
from repro_torch.sim.ledger import (Ledger, init_ledger, ledger_update,
                                    summarize)
from repro_torch.sim.report import (MOBILITY_COLUMNS, MPC_COLUMNS,
                                    RISK_COLUMNS, TELEMETRY_COLUMNS,
                                    format_table, mobility_sweep_rows,
                                    mpc_recourse_rows, risk_sweep_rows,
                                    scenario_rows, state_nbytes,
                                    telemetry_rows)
from repro_torch.sim.scenarios import (MOBILITY_SWEEP, RISK_BETAS,
                                       RISK_MEMBERS, Scenario, build_batch,
                                       build_params, default_library,
                                       forecast_bust_library,
                                       mobility_sweep_library,
                                       risk_sweep_library)
from repro_torch.sim.telemetry import (TRACE_FIELDS, DayTelemetry,
                                       day_telemetry, format_stage_table,
                                       profile_setup, profile_stages,
                                       read_jsonl, stage_rows,
                                       telemetry_records, write_jsonl)

__all__ = [
    "SimConfig", "SimParams", "SimState", "make_init", "make_day_step",
    "make_rollout", "rollout_batch", "rollout_batch_sharded",
    "rollout_sequential",
    "Ledger", "init_ledger", "ledger_update", "summarize",
    "Scenario", "build_params", "build_batch", "default_library",
    "forecast_bust_library", "mobility_sweep_library",
    "risk_sweep_library", "MOBILITY_SWEEP", "RISK_BETAS", "RISK_MEMBERS",
    "scenario_rows", "format_table", "mobility_sweep_rows",
    "mpc_recourse_rows", "risk_sweep_rows", "state_nbytes",
    "telemetry_rows", "MOBILITY_COLUMNS", "MPC_COLUMNS", "RISK_COLUMNS",
    "TELEMETRY_COLUMNS",
    "DayTelemetry", "day_telemetry", "telemetry_records", "write_jsonl",
    "read_jsonl", "stage_rows", "profile_stages", "profile_setup",
    "format_stage_table", "TRACE_FIELDS",
]
