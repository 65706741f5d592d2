"""The share of the traced window in which the card ran no kernel, copy
or fill, in % (torch.profiler's device events; devtrace.py)."""


def read(record):
    trace = record.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
