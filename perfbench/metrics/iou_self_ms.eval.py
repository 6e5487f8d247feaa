"""``iou_self_ms.eval``: device milliseconds a call of ``metrics.iou_full``
that its ``metrics.voxels`` spans do not cover (the intersections and
unions, the angles, the gauge), over the profiled batches."""

from perfbench.program_spans import per_call


def read(record):
    return per_call("metrics.iou_full", key="self_ms")
