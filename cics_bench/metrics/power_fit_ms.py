"""Device milliseconds of the power stage (the PD piecewise-linear fit,
``core/stages.py`` ``power_stage``) at the cell's shapes: events around
the benchmark's own call after the traced window, from the burned-in
state, best of five (the timing arithmetic of the program's
``sim/telemetry.py`` ``_time_stage``)."""


def measure(ctx):
    from repro_torch.core import prng, stages
    params, state = ctx.params, ctx.state
    key = prng.fold_in(prng.fold_in(params.key, state.day), 1)
    usage = state.pred.usage_ring if ctx.cfg.streaming else state.hist_usage
    args = (usage, params.lam, params.truth["capacity"],
            stages.pd_truth(params), key)
    return ctx.best_of(lambda: stages.power_stage(*args))


def read(run):
    return run.measured.get("power_fit_ms")
