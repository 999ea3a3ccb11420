"""The skinning kernel's share of its roofline: the least time one launch at
N = 1 needs (its bytes over 3.35 TB/s) over the kernel's mean device time
in the traced segment, in percent."""

from perfbench.harness import work


def read(r, cfg):
    t = r.get("trace")
    times = [d for name, ds in (t or {}).get("kernels", {}).items()
             if "lbs_skin" in name for d in ds]
    if not times:
        return None
    least = work.skin_least_seconds(1, cfg["smpl"]["num_vertices"])
    return 100.0 * least / (sum(times) / len(times))
