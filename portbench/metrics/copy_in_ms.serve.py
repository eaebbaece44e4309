"""Host milliseconds a request inside the program's ``bnn.serve.copy_in``
span (``Predictor.__call__``'s cast of the request and its copy to the
device), over the profiled slice."""
from portbench.spans import SERVE_COPY_IN, span_ms

UNIT = "ms"


def read(rec):
    return span_ms(rec, SERVE_COPY_IN) if rec.kind == "serve" else None
