"""``net_ms.eval``: device milliseconds a call of the span ``eval.predict``
(the model in eval mode), over the profiled batches: the program's own
counterpart of ``predict_ms.eval``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("eval.predict")
