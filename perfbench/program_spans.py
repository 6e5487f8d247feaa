"""What the program's own spans read (``sqtpu_torch.utils.profiling``):
its ``span_totals()``, by span name, over the latest collection, which a
``--trace 1`` run's profiled steps or batches make. A run whose program
has no spans, or has not loaded the module, reads nothing."""

from __future__ import annotations

import sys

MODULE = "sqtpu_torch.utils.profiling"


def totals() -> dict:
    """``span_totals()`` of the loaded module; empty when there is none."""
    read = getattr(sys.modules.get(MODULE), "span_totals", None)
    return read() if read is not None else {}


def per_call(name: str, key: str = "device_ms", per: str | None = None,
             count: str = "calls"):
    """Span ``name``'s total ``key`` divided by the ``count`` of span
    ``per`` (``name`` itself by default); None where either span is
    missing or the count is 0."""
    t = totals()
    spans, per = t.get(name), t.get(per or name)
    if spans is None or per is None or not per[count]:
        return None
    return spans[key] / per[count]
