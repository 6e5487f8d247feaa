"""``refine_render_ms.eval``: device milliseconds a batch of the span
``refine.render`` (every in-loop render of the corrector's estimates: K3
and its packing), over the profiled batches: its device time ÷ the calls
of ``eval.predict``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("refine.render", per="eval.predict")
