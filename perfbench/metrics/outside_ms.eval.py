"""``outside_ms.eval``: device milliseconds a batch between the program's
calls, over the profiled batches: the wait before each ``data.sample``
root call from the end of the previous root call (the errors, the five
host reads, the loop's Python), over the batches that had one."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("data.sample", key="gap_before_ms",
                    count="gap_before_calls")
