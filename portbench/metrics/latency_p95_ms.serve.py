"""95th percentile of the window's request latencies in milliseconds, as
``serve_p95_ms`` takes it: the end-to-end tail of a cell whose runs spread
too widely in it for the tail's bound, read here per layer instead."""
import numpy as np

UNIT = "ms"


def read(rec):
    lat = rec.window.get("latency_s") if rec.kind == "serve" else None
    return float(np.percentile(1e3 * np.asarray(lat), 95)) if lat else None
