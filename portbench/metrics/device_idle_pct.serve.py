"""Share of the profiled slice's wall time with no kernel running: one minus
the union of the kernel intervals over the slice."""
from portbench.readers import idle_pct

UNIT = "%"


def read(rec):
    return idle_pct(rec, "serve")
