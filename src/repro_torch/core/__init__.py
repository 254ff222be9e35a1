"""CICS pipelines (carbon, power, forecast, vcc, admission, slo, spatial),
the solver layer, the threefry random stream and the staged day."""
