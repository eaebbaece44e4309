"""Share of the profiled slice's idle time (no kernel running) with the host
inside the program's ``bnn.train.forward`` span (the step's forward and
loss), each gap split exactly by its overlap with the spans."""
from portbench.spans import TRAIN_FORWARD, idle_in_pct

UNIT = "%"


def read(rec):
    return idle_in_pct(rec, TRAIN_FORWARD) if rec.kind == "train" else None
