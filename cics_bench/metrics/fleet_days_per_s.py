"""Planned fleet-days a second: the batch times the days whose end event
completed inside the measured window, over the window's seconds."""


def read(run):
    w = run.window
    if not w:
        return None
    return w["batch"] * len(w["ends_ms"]) / w["seconds"]
