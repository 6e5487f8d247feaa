"""``predict_ms.eval``: device milliseconds a batch of
``evaluate.predict`` (the model in eval mode), from CUDA events around
each call of the window, summed and divided by the window's batches."""


def read(record):
    calls = record.get("spans_ms", {}).get("predict")
    if not calls:
        return None
    return sum(calls) / record["batches"]
