"""``score_ms.eval``: device milliseconds a batch of
``ops.metrics.iou_full`` (the IoU tuple), from CUDA events around each
call of the window, summed and divided by the window's batches."""


def read(record):
    calls = record.get("spans_ms", {}).get("iou_full")
    if not calls:
        return None
    return sum(calls) / record["batches"]
