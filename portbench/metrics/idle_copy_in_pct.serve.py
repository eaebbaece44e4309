"""Share of the profiled slice's idle time (no kernel running) with the host
inside the program's ``bnn.serve.copy_in`` span (the request's cast and copy
to the device), each gap split exactly by its overlap with the spans."""
from portbench.spans import SERVE_COPY_IN, idle_in_pct

UNIT = "%"


def read(rec):
    return idle_in_pct(rec, SERVE_COPY_IN) if rec.kind == "serve" else None
