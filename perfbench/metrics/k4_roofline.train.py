"""``k4_roofline.train``: K4's share of its bound over the profiled steps,
in %: the least time of the lattice points after the exact-zero cull on
the steps' labels and predictions (``perfbench.counts.bounds
.k4_bound_ms``) ÷ K4's device time in the trace."""


def read(record):
    seconds = record.get("kernel_s", {}).get("K4", 0.0)
    if not seconds or not record["bound_ms"].get("K4"):
        return None
    return 100.0 * record["bound_ms"]["K4"] / (seconds * 1e3)
