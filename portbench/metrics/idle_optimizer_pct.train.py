"""Share of the profiled slice's idle time (no kernel running) with the host
inside the program's ``bnn.train.optimizer`` span (the optimizer's step),
each gap split exactly by its overlap with the spans."""
from portbench.spans import TRAIN_OPTIMIZER, idle_in_pct

UNIT = "%"


def read(rec):
    return idle_in_pct(rec, TRAIN_OPTIMIZER) if rec.kind == "train" else None
