"""``opt_ms.train``: device milliseconds a step of the span
``train.optimizer`` (clip and Adam), over the profiled steps: its device
time ÷ the calls of ``train.step``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("train.optimizer", per="train.step")
