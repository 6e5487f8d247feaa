"""``refine_base_ms.eval``: device milliseconds a batch of the span
``refine.base`` (the corrector's ResNetSQ base in eval mode), over the
profiled batches: its device time ÷ the calls of ``eval.predict``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("refine.base", per="eval.predict")
