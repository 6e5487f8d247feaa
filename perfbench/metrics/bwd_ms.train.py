"""``bwd_ms.train``: device milliseconds a step of the span
``train.backward`` (K2 or the loss's gradient, the recompute of
``remat``, the encoder's backward), over the profiled steps: its device
time ÷ the calls of ``train.step``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("train.backward", per="train.step")
