"""``loss_ms.train``: device milliseconds a step of the span ``train.loss``
(the step's loss: K1 or K4 and their glue), over the profiled steps: its
device time ÷ the calls of ``train.step``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("train.loss", per="train.step")
