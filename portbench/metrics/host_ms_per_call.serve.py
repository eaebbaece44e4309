"""Mean host milliseconds inside ``Predictor.__call__`` over the window's
requests, from the benchmark's clock around the call up to its return
(before the logits are read; the blocking copy of the input is inside)."""

UNIT = "ms"


def read(rec):
    calls = rec.window.get("call_s") if rec.kind == "serve" else None
    return 1e3 * sum(calls) / len(calls) if calls else None
