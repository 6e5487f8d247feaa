"""``refine_pass_ms.eval``: device milliseconds a batch of the span
``refine.pass`` (every pass's two-channel stack, shared block and
``apply_delta``), over the profiled batches: its device time ÷ the calls
of ``eval.predict``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("refine.pass", per="eval.predict")
