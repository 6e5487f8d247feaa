"""``data_ms.train``: device milliseconds a step of the program's
``make_batch`` (sampling and K3), from CUDA events around each call of
the window, summed and divided by the window's steps."""


def read(record):
    calls = record.get("spans_ms", {}).get("make_batch")
    if not calls:
        return None
    return sum(calls) / record["steps"]
