"""``make_batch_ms.train``: device milliseconds a call of the span
``data.make_batch`` (sampling and K3), over the profiled steps: the
program's own counterpart of ``data_ms.train``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("data.make_batch")
