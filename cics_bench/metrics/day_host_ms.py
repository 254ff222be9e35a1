"""Host milliseconds a planned day takes in the measured window: the host
time between consecutive end-of-day hooks of a rollout (the day step, then
the ledger's update), averaged over every day of every rollout, with no
synchronisation."""


def read(run):
    days = run.spans.get("day_host")
    return 1e3 * sum(days) / len(days) if days else None
