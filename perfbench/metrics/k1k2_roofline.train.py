"""``k1k2_roofline.train``: K1's and K2's share of their bound over the
profiled steps, in %: the least time of the points after the exact-zero
cull on the steps' own predictions (``perfbench.counts.bounds
.k1k2_bound_ms``) ÷ K1's plus K2's device time in the trace."""


def read(record):
    ks = record.get("kernel_s", {})
    seconds = ks.get("K1", 0.0) + ks.get("K2", 0.0)
    if not seconds or not record["bound_ms"].get("K1K2"):
        return None
    return 100.0 * record["bound_ms"]["K1K2"] / (seconds * 1e3)
