"""Host milliseconds a request inside the program's ``bnn.serve.forward``
span (the padded batches through the served model: the modules' Python,
the kernels' wrappers and their launches), over the profiled slice."""
from portbench.spans import SERVE_FORWARD, span_ms

UNIT = "ms"


def read(rec):
    return span_ms(rec, SERVE_FORWARD) if rec.kind == "serve" else None
