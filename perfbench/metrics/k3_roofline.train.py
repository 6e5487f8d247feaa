"""``k3_roofline.train``: K3's share of its bound over the profiled
steps, in %: the least time of the inside tests its inputs need and of
its bytes (``perfbench.counts.bounds.k3_bound_ms``) ÷ its device time in
the trace."""


def read(record):
    seconds = record.get("kernel_s", {}).get("K3", 0.0)
    if not seconds:
        return None
    return 100.0 * record["bound_ms"]["K3"] / (seconds * 1e3)
