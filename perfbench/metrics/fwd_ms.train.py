"""``fwd_ms.train``: device milliseconds a step of the span
``train.forward`` (train mode, the float32 cast, the model), over the
profiled steps: its device time ÷ the calls of ``train.step``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("train.forward", per="train.step")
