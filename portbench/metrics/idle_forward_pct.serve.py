"""Share of the profiled slice's idle time (no kernel running) with the host
inside the program's ``bnn.serve.forward`` span (the served model's Python,
wrappers and launches), each gap split exactly by its overlap with the
spans."""
from portbench.spans import SERVE_FORWARD, idle_in_pct

UNIT = "%"


def read(rec):
    return idle_in_pct(rec, SERVE_FORWARD) if rec.kind == "serve" else None
