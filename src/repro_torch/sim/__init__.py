"""Scenario engine + batched fleet simulation, PyTorch port (main path):
the scenario library (``scenarios``), the batched rollout engine over a
(scenario x seed) axis (``engine``), the emissions ledger with its unshaped
counterfactual (``ledger``) and per-scenario reporting (``report``)."""
from repro_torch.sim.engine import (SimConfig, SimParams, SimState,  # noqa
                                    make_day_step, make_init, make_rollout,
                                    rollout_batch, rollout_sequential)
from repro_torch.sim.ledger import (Ledger, init_ledger,  # noqa: F401
                                    ledger_update, summarize)
from repro_torch.sim.report import format_table, scenario_rows  # noqa
from repro_torch.sim.scenarios import (Scenario, build_batch,  # noqa: F401
                                       build_params, default_library)
