"""Host CPU milliseconds a planned day takes in the measured window: the
main thread's CPU time (``time.thread_time``) between consecutive
end-of-day hooks, averaged over every day of every rollout. Beside
``day_host_ms`` (wall time) it tells the host's own work from its
waiting, where the wait sleeps; a wait that spins counts here too, and
``runtime_call_ms`` shows it."""


def read(run):
    days = run.spans.get("day_host_cpu")
    return 1e3 * sum(days) / len(days) if days else None
