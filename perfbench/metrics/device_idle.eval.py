"""``device_idle.eval``: the card's idle share of the profiled closed-loop batches,
in %: 1 − the union of its operations' intervals ÷ the span of the
trace."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace["span_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["span_s"])
