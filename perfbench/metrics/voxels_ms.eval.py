"""``voxels_ms.eval``: device milliseconds a batch of the span
``metrics.voxels`` (the occupancy grids of the three IoUs), over the
profiled batches: its device time ÷ the calls of ``metrics.iou_full``."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("metrics.voxels", per="metrics.iou_full")
