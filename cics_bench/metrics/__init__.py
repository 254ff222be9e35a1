"""One reader a per-layer metric: ``read(run)`` returns the metric's value
from a traced run (``harness.Run``), or None where the run has nothing for
it to read."""
