"""``k3_roofline.eval``: K3's share of its bound over the profiled
closed-loop batches, in %: the least time of the inside tests and bytes
of every launch, the input render and the in-loop ones, each on its own
parameters and settings (``perfbench.counts.bounds.k3_bound_ms``) ÷ K3's
device time in the trace."""


def read(record):
    seconds = record.get("kernel_s", {}).get("K3", 0.0)
    if not seconds or not record.get("bound_ms", {}).get("K3"):
        return None
    return 100.0 * record["bound_ms"]["K3"] / (seconds * 1e3)
